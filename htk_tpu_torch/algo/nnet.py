"""ANN training: frame cross-entropy SGD with HTK's schedulers, in torch.

The PyTorch counterpart of `htk_tpu/algo/nnet.py` (`HTKTools/HNTrainSGD.c`
+ `HTKLib/HNCache.c`): frame-level cross-entropy training of a
feed-forward net on tied-state targets from forced alignment, with
minibatching, frame-level shuffling (FRAMERAND), momentum SGD, and the
NewBob / exponential-decay / list / AdaGrad / fixed learning-rate
schedules; and the sequence criterion (MMI against a phone-loop
denominator).

Gradients come from `torch.autograd`; the updates are written by hand
under `torch.no_grad()`, because HTK's rules are not `torch.optim`'s:

  momentum  v = m*v - lr*g;  p += v      (torch.optim.SGD keeps
            buf = m*buf + g; p -= lr*buf, which parts from this as soon
            as NEWBOB changes lr)
  AdaGrad   s += g*g;  p -= lr*g / sqrt(k + s)   (not sqrt(s) + eps)
  WEIGHTDECAY adds wd*p to the gradients, then GRADCLIP clamps them

The splits and epoch orders come from the same numpy generator as the
reference, so both packages visit the frames in the same order. The
frame cache lives on the device while it is under 4 GiB (the HNCache
role); an epoch is then a loop of steps that gather their minibatch on
the device. Matmuls run with TF32 off (PRECISION = highest).

The sequence criterion's forward and backward scans over an utterance's
HMM graph (`_gamma_phys`) are one `ops/fb_scans` launch: the
hand-written CUDA kernel on the card, its plain version on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.ann import (LSTMP, ANNDef, ANNModule, ann_arrays, ann_out,
                          forward, splice)
from ..ops.fb_scans import fb_scans
from ..ops.lstmp import CellSteps
from ..ops.outp import matmul_precision
from ..utils.errors import HError
from ..utils.logmath import LZERO, exp_or_zero
from ..utils.metrics import span

CACHE_BYTES = 4 << 30  # frame caches up to this size live on the device


@dataclass
class SGDConfig:
    lr: float = 0.002  # LEARNRATE
    momentum: float = 0.5  # MOMENTUM
    batch_size: int = 256  # MINIBATCHSIZE
    n_epochs: int = 10  # MAXEPOCHNUM
    # LRSCHEDULER: NEWBOB | EXPDECAY | LIST | ADAGRAD | FIXED
    scheduler: str = "NEWBOB"
    newbob_ramp: float = 0.005  # improvement threshold to start decay
    newbob_stop: float = 0.0001  # improvement threshold to stop
    decay_factor: float = 0.5
    lr_list: Optional[List[float]] = None  # LIST: per-epoch rates
    adagrad_k: float = 1.0  # ADAGRAD damping constant
    frame_rand: bool = True  # FRAMERAND
    seed: int = 0
    weight_decay: float = 0.0  # WEIGHTDECAY: L2 penalty added to grads
    grad_clip: float = 0.0  # GRADCLIP: elementwise gradient clamp


def make_cache(utt_feats: List[np.ndarray], utt_targets: List[np.ndarray],
               context: int) -> Tuple[np.ndarray, np.ndarray]:
    """Splice + concatenate all utterances into one frame-level dataset
    (the HNCache role); targets are per-frame tied-state ids from forced
    alignment. Host numpy arrays."""
    xs, ys = [], []
    for f, t in zip(utt_feats, utt_targets):
        if f.shape[0] != t.shape[0]:
            HError(7730, "make_cache: feature/target length mismatch")
        xs.append(splice(torch.as_tensor(np.asarray(f, np.float32)),
                         context).numpy())
        ys.append(t.astype(np.int32))
    return np.concatenate(xs), np.concatenate(ys)


def _regularise(grads, params, wd, clip):
    """WEIGHTDECAY adds the L2 term to the gradients; GRADCLIP clamps
    them elementwise."""
    if wd:
        grads = [g + wd * p for g, p in zip(grads, params)]
    if clip:
        grads = [g.clamp(-clip, clip) for g in grads]
    return grads


def _ce(model, x, y):
    """(mean CE, mean frame accuracy) of a minibatch, with the graph."""
    logits = model(x)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(1, y[:, None].long()).mean()
    acc = (logits.argmax(dim=1) == y).to(torch.float32).mean()
    return ce, acc


def _grads(loss, model):
    return list(torch.autograd.grad(loss, list(model.parameters())))


@torch.no_grad()
def _momentum_update(model, vel, grads, lr, momentum, wd, clip):
    """HNTrainSGD's momentum rule, in place: v = m*v - lr*g; p += v."""
    flat = list(model.parameters())
    grads = _regularise(grads, flat, wd, clip)
    for p, v, g in zip(flat, vel, grads):
        v.mul_(momentum).sub_(lr * g)
        p.add_(v)


@torch.no_grad()
def _adagrad_update(model, ssg, grads, lr, k, wd, clip):
    """The AdaGrad rule, in place: s += g*g; p -= lr*g / sqrt(k + s)."""
    flat = list(model.parameters())
    grads = _regularise(grads, flat, wd, clip)
    for p, s, g in zip(flat, ssg, grads):
        s.add_(g * g)
        p.sub_(lr * g / torch.sqrt(k + s))


def _sgd_step(model, vel, x, y, lr, momentum, wd=0.0, clip=0.0):
    """One momentum step on a minibatch; returns (CE, accuracy) tensors."""
    with torch.enable_grad():
        ce, acc = _ce(model, x, y)
        grads = _grads(ce, model)
    _momentum_update(model, vel, grads, lr, momentum, wd, clip)
    return ce.detach(), acc


def _sgd_step_adagrad(model, ssg, x, y, lr, k, wd=0.0, clip=0.0):
    """One AdaGrad step (HNTrainSGD.c AdaGrad scheduler): per-parameter
    rate lr / sqrt(k + sum of squared gradients)."""
    with torch.enable_grad():
        ce, acc = _ce(model, x, y)
        grads = _grads(ce, model)
    _adagrad_update(model, ssg, grads, lr, k, wd, clip)
    return ce.detach(), acc


def _sgd_step_soft(model, vel, x, c, lr, momentum, wd=0.0, clip=0.0):
    """Sequence-discriminative step: c = gamma_num - gamma_den per frame
    and state; dF/dlogit = -c exactly because each frame's c sums to 0,
    so the MMI gradient is plain soft-target backprop."""
    with torch.enable_grad():
        logp = torch.log_softmax(model(x), dim=-1)
        loss = -(c * logp).sum(dim=1).mean()
        grads = _grads(loss, model)
    _momentum_update(model, vel, grads, lr, momentum, wd, clip)
    return loss.detach()


@torch.no_grad()
def _eval_step(model, x, y):
    """Summed CE and correct frames over (x, y)."""
    logits = model(x)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(1, y[:, None].long()).sum()
    acc = (logits.argmax(dim=1) == y).to(torch.float32).sum()
    return ce, acc


def train_ann(ann: ANNDef, x: np.ndarray, y: np.ndarray, cfg: SGDConfig,
              holdout: float = 0.1, trace: int = 0, *, device,
              on_epoch=None) -> ANNDef:
    """Train in place on `device`; returns the ANN with updated weights
    and priors. `on_epoch(epoch, lr, train CE, train acc, cv CE, cv acc)`
    is called after each epoch."""
    dev = torch.device(device)
    n = x.shape[0]
    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(n)
    n_cv = max(1, int(n * holdout))
    cv_idx, tr_idx = perm[:n_cv], perm[n_cv:]
    xtr, ytr = x[tr_idx], y[tr_idx]
    xcv = torch.as_tensor(x[cv_idx], device=dev)
    ycv = torch.as_tensor(y[cv_idx], device=dev)

    model = ANNModule(ann, dev)
    # momentum or AdaGrad state
    vel = [torch.zeros_like(p) for p in model.parameters()]

    lr = cfg.lr
    prev_cv = None
    ramping = False
    bs = cfg.batch_size
    adagrad = cfg.scheduler == "ADAGRAD"
    # the device-resident frame cache (HNCache); past CACHE_BYTES each
    # minibatch is gathered on the host and shipped
    use_cache = xtr.nbytes + ytr.nbytes < CACHE_BYTES
    if use_cache:
        xd = torch.as_tensor(xtr, device=dev)
        yd = torch.as_tensor(ytr, device=dev)
    with matmul_precision("highest"):
        for epoch in range(cfg.n_epochs):
            if cfg.scheduler == "LIST" and cfg.lr_list:
                lr = cfg.lr_list[min(epoch, len(cfg.lr_list) - 1)]
            elif cfg.scheduler == "EXPDECAY":
                lr = cfg.lr * (cfg.decay_factor ** epoch)
            order = (rng.permutation(len(xtr)) if cfg.frame_rand
                     else np.arange(len(xtr)))
            # per-batch means sum on the device; the last, partial
            # minibatch trains too (HNCache's last batch)
            tot_ce = torch.zeros((), device=dev)
            tot_acc = torch.zeros((), device=dev)
            nb = 0
            idx_all = torch.as_tensor(order, device=dev) if use_cache \
                else None
            for i in range(0, len(order), bs):
                if use_cache:
                    ib = idx_all[i: i + bs]
                    xb, yb = xd[ib], yd[ib]
                else:
                    ib = order[i: i + bs]
                    xb = torch.as_tensor(xtr[ib], device=dev)
                    yb = torch.as_tensor(ytr[ib], device=dev)
                if adagrad:
                    ce, acc = _sgd_step_adagrad(
                        model, vel, xb, yb, lr, cfg.adagrad_k,
                        wd=cfg.weight_decay, clip=cfg.grad_clip)
                else:
                    ce, acc = _sgd_step(
                        model, vel, xb, yb, lr, cfg.momentum,
                        wd=cfg.weight_decay, clip=cfg.grad_clip)
                tot_ce += ce
                tot_acc += acc
                nb += 1
            ce_s, acc_s = _eval_step(model, xcv, ycv)
            cv_ce, cv_acc = float(ce_s) / n_cv, float(acc_s) / n_cv
            tr_ce = float(tot_ce) / max(nb, 1)
            tr_acc = float(tot_acc) / max(nb, 1)
            if trace:
                print(f"  epoch {epoch + 1}: lr={lr:.5f} train "
                      f"CE={tr_ce:.4f} acc={tr_acc:.3f} | cv "
                      f"CE={cv_ce:.4f} acc={cv_acc:.3f}")
            if on_epoch is not None:
                on_epoch(epoch, lr, tr_ce, tr_acc, cv_ce, cv_acc)
            if cfg.scheduler == "NEWBOB" and prev_cv is not None:
                improvement = prev_cv - cv_ce
                if ramping and improvement < cfg.newbob_stop:
                    break
                if improvement < cfg.newbob_ramp:
                    ramping = True
                if ramping:
                    lr *= cfg.decay_factor
            prev_cv = cv_ce

    # write back + priors from target frequencies
    model.write_back(ann)
    K = ann.out_dim
    counts = np.bincount(y, minlength=K).astype(np.float64) + 1.0
    ann.target_priors = (counts / counts.sum()).astype(np.float32)
    return ann


def hybrid_outp(ann: ANNDef, feats, prior_scale: float = 1.0, *, device,
                model=None, lengths=None,
                precision: str = "highest") -> torch.Tensor:
    """(T, D) frames -> (T, K) hybrid scores log P(s|x) - scale*log P(s)
    on `device` (HNForward / hybrid HVite / HDecode -N: scaled posteriors
    replace GMM b_j(o_t)). A padded batch (B, T, D) with its real
    `lengths` (B,) gives (B, T, K): the splice clamps at each utterance's
    own last frame, and the padded rows hold finite scores that no
    decode reads. The matmuls run under `precision` ("highest": FP32;
    "default": TF32 on the card); activations, the log-softmax and the
    prior subtraction are float32. `model` reuses `ANNModule(ann,
    device)` across calls.

    A net with a recurrent layer or an output delay d (`_stepped_logits`)
    runs T + d frame steps, in which the frames past an utterance's end
    repeat its last real frame (the splice's clamp rule), so that row t
    of an utterance depends on its own frames alone; row t of the scores
    is the net's output at step t + d. A (T, D) call is a batch of one.

    One call is the span `htk.ann.forward`, counting the rows scored
    (`frames`, padding included), `flops` (2 x the matrices' weights x
    the rows stepped, T + d a row of the batch), `weight_bytes` (the
    weights, biases and peepholes, read once a call) and `act_bytes`
    (each layer's input and output rows, once); the splice is
    `htk.ann.splice`, each LSTMP layer's frame loop `htk.ann.recur`."""
    dev = torch.device(device)
    if model is None:
        model = ANNModule(ann, dev)
    shape = np.shape(feats)
    frames = int(np.prod(shape[:-1]))
    steps = frames // shape[-2] * (shape[-2] + ann.out_delay)
    mats = [m for l in ann.layers
            for m in ((l.weight, l.recur, l.proj) if l.activation == LSTMP
                      else (l.weight,))]
    widths = sum(l.weight.shape[1] + ann_out(l) for l in ann.layers)
    with span("htk.ann.forward", frames=frames,
              flops=2 * sum(m.size for m in mats) * steps,
              weight_bytes=4 * sum(a.size for l in ann.layers
                                   for a in ann_arrays(l)),
              act_bytes=4 * widths * steps):
        x = torch.as_tensor(feats if torch.is_tensor(feats) else
                            np.asarray(feats, np.float32),
                            dtype=torch.float32, device=dev)
        with torch.no_grad(), matmul_precision(precision):
            if ann.recurrent or ann.out_delay:
                logits = _stepped_logits(ann, model, x.reshape(
                    -1, *shape[-2:]), lengths)
            else:
                with span("htk.ann.splice"):
                    x = splice(x, ann.context, lengths)
                logits = model(x.reshape(frames, -1))
            logpost = torch.log_softmax(logits, dim=-1)
            if ann.target_priors is not None:
                pri = torch.as_tensor(np.asarray(ann.target_priors,
                                                 np.float32), device=dev)
                logpost = logpost - prior_scale * torch.log(pri)[None, :]
    return logpost.reshape(*shape[:-1], -1)


def _stepped_logits(ann: ANNDef, model, x, lengths) -> torch.Tensor:
    """The logits (B, T, K) of a padded batch x (B, T, D) through a net
    with recurrent layers or an output delay d: the frames extended to
    S = T + d steps (past each utterance's last real frame, that frame),
    spliced, then every layer in order over the S steps, time-major
    (affine layers on all S x B rows at once, an LSTMP layer by
    `_lstmp_layer`), and steps d..d + T - 1 kept."""
    B, T = x.shape[:2]
    d = ann.out_delay
    dev = x.device
    last = torch.as_tensor(np.maximum(np.asarray(
        [T] * B if lengths is None else lengths, np.int64), 1) - 1,
        device=dev)
    idx = torch.minimum(torch.arange(T + d, device=dev)[None],
                        last[:, None])
    x = x[torch.arange(B, device=dev)[:, None], idx]
    with span("htk.ann.splice"):
        x = splice(x, ann.context, lengths)
    h = x.transpose(0, 1).contiguous()  # (S, B, D')
    for l, p in zip(ann.layers, model.params()):
        if l.activation == LSTMP:
            h = _lstmp_layer(h, *p)
        else:
            h = forward([p], [l.activation], h)
    return h[d:].transpose(0, 1)


def _lstmp_layer(h, wx, wr, peep, b, wrm) -> torch.Tensor:
    """One LSTMP layer over a call's steps: h (S, B, n_in) time-major ->
    r (S, B, n_r). One GEMM of W_x over all S x B rows, then a step a
    frame (the span `htk.ann.recur`): the recurrent GEMM W_r r_{t-1}
    into the cell's kept row (skipped at t = 0, where r is 0), the cell
    (ops/lstmp: a kernel launch on the card, the plain version on the
    CPU), and the projection r_t = W_rm m_t into row t of the output."""
    S, B, _ = h.shape
    gx = torch.mm(h.reshape(S * B, -1), wx.T).reshape(S, B, -1)
    r = torch.empty((S, B, wrm.shape[0]), dtype=h.dtype, device=h.device)
    cell = CellSteps(gx, peep, b)
    with span("htk.ann.recur", frame_steps=S,
              kernel_steps=S if cell.on_card else 0):
        for t in range(S):
            if t:
                torch.mm(r[t - 1], wr.T, out=cell.gr)
            cell.step(t)
            torch.mm(cell.m, wrm.T, out=r[t])
    return r


def check_targets(ann: ANNDef, comp) -> None:
    """HError 7712 unless output k of `ann` is the compiled set's
    physical state k, the order the decoders' `state_scores` take: as
    many outputs as the set has states and, where the ANN names its
    targets, target k named after state k (its ~s macro, or HNTrainSGD's
    `S<k>`). Checked once, where a tool or caller builds the model."""
    if ann.out_dim != comp.n_states:
        HError(7712, "ANN: %d outputs for a set of %d states",
               ann.out_dim, comp.n_states)
    if not ann.target_names:
        return
    hset = getattr(comp, "_hset", None)
    macro = ({id(si): n for n, si in hset.macros["s"].items()}
             if hset is not None else {})
    for k, (name, si) in enumerate(zip(ann.target_names,
                                       comp._state_objs)):
        if name != f"S{k}" and name != macro.get(id(si)):
            HError(7712, "ANN: target %d is %s, not the set's state %d",
                   k, name, k)


# ---------------------------------------------------------------------------
# Sequence-discriminative (MMI) training: HNTrainSGD.c's sequence mode
# ---------------------------------------------------------------------------


def make_phone_loop(comp, loop_prob: float = None):
    """Denominator phone-loop HMM over every model in the set (host
    numpy, the reference's values byte for byte).

    All emitting models in parallel, uniform loop-back transitions, as
    ONE dense (Q, Q) logA so the generic scans run it unchanged. Returns
    (comp_state, logA, a0, aE). Tee (zero-emitting) models are left out.
    The reference adds each (exit block, entry block) pair's loop-back
    in a double loop over the models; here the same elementwise
    `logaddexp` runs over the whole (Q, Q) at once (Q = 10,332 at config
    #4's 3,444 models, 12 million pairs)."""
    sizes, offs, en, ex = [], [], [], []
    q = 0
    for mid in range(comp.n_models):
        n = int(comp.model_nstates[mid])
        e = n - 2
        if e <= 0:
            continue
        lt = comp.log_transp[comp.model_transp[mid]]
        offs.append(q)
        sizes.append(e)
        en.append(lt[0, 1: 1 + e])
        ex.append(lt[1: 1 + e, n - 1])
        q += e
    M = len(sizes)
    if M == 0:
        HError(7330, "make_phone_loop: no emitting models")
    lp = -np.log(M) if loop_prob is None else loop_prob

    comp_state = np.zeros(q, np.int32)
    logA = np.full((q, q), LZERO, np.float64)
    a0 = np.full(q, LZERO, np.float64)
    aE = np.full(q, LZERO, np.float64)
    k = 0
    for mid in range(comp.n_models):
        n = int(comp.model_nstates[mid])
        e = n - 2
        if e <= 0:
            continue
        o = offs[k]
        comp_state[o: o + e] = comp.model_states[mid, :e]
        lt = comp.log_transp[comp.model_transp[mid]]
        logA[o: o + e, o: o + e] = lt[1: 1 + e, 1: 1 + e]
        a0[o: o + e] = en[k] + lp
        aE[o: o + e] = ex[k]
        k += 1
    # loop-back: every model exit reaches every model entry
    ex_all = np.concatenate(ex)
    en_all = np.concatenate(en)
    logA = np.logaddexp(logA, ex_all[:, None] + lp + en_all[None, :])
    return (comp_state, logA.astype(np.float32), a0.astype(np.float32),
            aE.astype(np.float32))


def _gamma_phys(scores, comp_state, logA, a0, aE, n_states):
    """FB over an HMM graph with external state scores (T, S_phys) on
    their device: one fb_scans launch (alphas, betas, logP; no xi, as the
    reference computes none), then the occupancies scattered onto
    physical states. Returns ((T, S_phys) occupancies, logP tensor)."""
    dev = scores.device
    T = scores.shape[0]
    cs = torch.as_tensor(comp_state, device=dev).long()

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    outp = scores[:, cs][None].contiguous()  # (1, T, Q)
    t_real = torch.full((1,), T, dtype=torch.int32, device=dev)
    alphas, betas, logp, _xi = fb_scans(
        outp, f32(logA)[None].contiguous(), f32(a0)[None].contiguous(),
        f32(aE)[None].contiguous(), t_real, xi=False)
    gamma = exp_or_zero(alphas[0] + betas[0] - logp[0])  # (T, Q)
    gp = torch.zeros((T, n_states), dtype=gamma.dtype, device=dev)
    gp.index_add_(1, cs, gamma)
    return gp, logp[0]


def mmi_frame_targets(ann, comp, feats, names, loop, prior_scale=1.0, *,
                      device, model=None):
    """Per-frame MMI soft targets c = gamma_num - gamma_den over physical
    states ((T, S) tensor on `device`), plus the utterance's MMI
    objective contribution (logP_num - logP_den, a float), with the
    current net's hybrid scores. `loop` is make_phone_loop's tuple, as
    numpy arrays or as tensors on `device`."""
    from .composite import build_composite

    scores = hybrid_outp(ann, feats, prior_scale, device=device,
                         model=model)  # (T, S_phys)
    hmm = build_composite(comp, [comp.model_id(n) for n in names])
    gnum, lpn = _gamma_phys(scores, hmm.comp_state,
                            hmm.logA.astype(np.float32),
                            hmm.a0.astype(np.float32),
                            hmm.aE.astype(np.float32), comp.n_states)
    gden, lpd = _gamma_phys(scores, loop[0], loop[1], loop[2], loop[3],
                            comp.n_states)
    return gnum - gden, float(lpn - lpd)


def train_ann_sequence(ann, comp, utt_feats, names_list, cfg, n_iters=4,
                       trace=0, *, device):
    """Sequence-MMI fine-tuning (HNTrainSGD sequence criterion) on
    `device`.

    Alternates: (E) recompute numerator/denominator occupancies with the
    current net over every utterance, (M) one SGD pass over the frame
    pool with the soft-target MMI gradient. The reported objective
    sum(logP_num - logP_den) must rise. Returns (ann, objectives). The
    phone loop goes to the device once."""
    dev = torch.device(device)
    loop = tuple(torch.as_tensor(a, device=dev)
                 for a in make_phone_loop(comp))
    bs = cfg.batch_size
    objs = []
    for it in range(n_iters):
        model = ANNModule(ann, dev)
        cs, obj = [], 0.0
        for feats, names in zip(utt_feats, names_list):
            c, o = mmi_frame_targets(ann, comp, feats, names, loop,
                                     device=dev, model=model)
            cs.append(c)
            obj += o
        objs.append(obj)
        if trace:
            print(f"  MMI iter {it}: objective {obj:.2f}")
        x = torch.cat([splice(torch.as_tensor(np.asarray(f, np.float32),
                                              device=dev), ann.context)
                       for f in utt_feats])
        c = torch.cat(cs)
        vel = [torch.zeros_like(p) for p in model.parameters()]
        order = np.random.default_rng(cfg.seed + it).permutation(len(x))
        order_d = torch.as_tensor(order, device=dev)
        with matmul_precision("highest"):
            for i in range(0, len(order), bs):
                ib = order_d[i: i + bs]
                _sgd_step_soft(model, vel, x[ib], c[ib], cfg.lr,
                               cfg.momentum, wd=cfg.weight_decay,
                               clip=cfg.grad_clip)
        model.write_back(ann)
    return ann, objs
