"""Embedded Baum-Welch forward-backward, batched, in torch.

The PyTorch counterpart of `htk_tpu/algo/fb.py` (`HTKLib/HFB.c`): for a
padded batch of B utterances, each a dense composite HMM of Q states over
T frames,

  1. OutP of the states each composite touches (ops/outp.py)
  2. the backward scan, forward scan, logP and summed xi: `ops/fb_scans`,
     the hand-written CUDA kernel on the card, the three batched scans
     below on the CPU
  3. state and mixture occupancies, and the moment sums `L^T @ feats`
     (`torch.matmul`, TF32 off under PRECISION = highest)
  4. one scatter (`index_add_`) of the whole batch onto the physical
     accumulators (HTrain.c's tied accumulator sharing)

The JAX package vmaps a per-utterance core; here every step carries the
batch dimension itself. `forward_scan`, `backward_scan` and `xi_scan` are
the plain version of the scans kernel. For MMI's arc batches
(tools/hmmirest.py) `fb_batch` takes per-utterance `weights` and
`gather_outp`, which scores only the Gaussians each composite touches,
and `loglik_batch` is the forward scan's logP alone.
`mix_posteriors_utterance` gives one utterance's per-frame Gaussian
posteriors, the adaptation statistics of HERest -K. Not ported yet: the
FULLC scorer, the second channel of single-pass retraining (-r), and
`fb_utterance`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import fb_scans as _scans
from ..ops.outp import matmul_precision, mix_scores, pack_gaussians
from ..utils.logmath import LZERO, exp_or_zero, ladd_reduce


class Accumulators(NamedTuple):
    """HTK's MuAcc/VaAcc/WtAcc/TrAcc, as tensors on one device."""

    occ: torch.Tensor  # (M,) mixture occupancies
    sum_x: torch.Tensor  # (M, D) occupancy-weighted feature sums
    sum_xx: torch.Tensor  # (M, D) occupancy-weighted squared sums
    wt_occ: torch.Tensor  # (S, maxmix) per-state mixture occupancies
    tr: torch.Tensor  # (TR_FLAT,) transition counts (flat (Tn, Nmax, Nmax))
    total_logp: torch.Tensor  # () sum of per-utterance log likelihoods
    total_frames: torch.Tensor  # () total frames accumulated
    n_utts: torch.Tensor  # () utterances accumulated


def zero_accs(n_mix: int, dim: int, n_states: int, max_mix: int,
              tr_flat: int, *, device) -> Accumulators:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return Accumulators(occ=z(n_mix), sum_x=z(n_mix, dim),
                        sum_xx=z(n_mix, dim), wt_occ=z(n_states, max_mix),
                        tr=z(tr_flat), total_logp=z(), total_frames=z(),
                        n_utts=z())


def forward_scan(outp, logA, a0, t_real, betas=None):
    """alpha_t for t = 0..T-1 (HFB.c StepAlpha); (B, T, Q) stacked.

    With `betas` given (beam-pruned FB, HERest -t), each alpha_t is
    confined to the beta-active band: states whose beta was beamed away
    get alpha = LZERO and zero occupancy."""
    alphas = torch.empty_like(outp)
    alpha = None
    for t in range(outp.shape[1]):
        pred = a0 if t == 0 else ladd_reduce(alpha[:, :, None] + logA, dim=1)
        alpha = pred + outp[:, t]
        if betas is not None:
            alpha = torch.where(betas[:, t] > LZERO / 2, alpha, LZERO)
        alphas[:, t] = alpha
    return alphas


def backward_scan(outp, logA, aE, t_real, beam: Optional[float] = None):
    """beta_t for t = 0..T-1 (HFB.c SetBeta); (B, T, Q) stacked.

    beta at each utterance's last frame (t_real-1) is aE: the recursion
    resets there, so padding frames never reach real betas. `beam` applies
    HFB's pruning: states whose beta falls below the frame's best by more
    than the beam die (LZERO)."""
    T = outp.shape[1]
    last = (t_real.long() - 1)[:, None]
    betas = torch.empty_like(outp)
    beta = torch.full_like(outp[:, 0], LZERO)
    for t in range(T - 1, -1, -1):
        o_next = outp[:, t + 1] if t + 1 < T else torch.zeros_like(beta)
        val = ladd_reduce(logA + (o_next + beta)[:, None, :], dim=2)
        beta = torch.where(last == t, aE, val)
        if beam is not None:
            beta = torch.where(beta < beta.amax(-1, keepdim=True) - beam,
                               LZERO, beta)
        betas[:, t] = beta
    return betas


def xi_scan(alphas, betas, outp, logA, logp, t_real):
    """Summed transition posteriors xi (B, Q, Q), the TrAcc integrand:

    xi[b,i,j] = sum_{t<t_real-1} exp(alpha_t[i] + A[i,j]
                                     + outp_{t+1}[j] + beta_{t+1}[j] - logP)
    """
    xi = torch.zeros_like(logA)
    lp = logp[:, None, None]
    for t in range(outp.shape[1] - 1):
        valid = (t < t_real - 1).to(outp.dtype)[:, None, None]
        tgt = outp[:, t + 1] + betas[:, t + 1]
        term = exp_or_zero(((alphas[:, t, :, None] + logA)
                            + tgt[:, None, :]) - lp)
        xi = xi + term * valid
    return xi


def _gathered_mix_scores(feats, st_mix, means, variances, gconsts,
                         precision: str = "highest"):
    """Per-Gaussian log-likelihoods of only the Gaussians each composite
    touches: frames (B, T, D) x physical mixture ids (B, Q, slots) ->
    (B, T, Q, slots) scores.

    Scoring all M Gaussians makes a (B, T, M) plane, 0.52 GB at an arc
    launch of 256 x 32 frames over config #4's 15,936 Gaussians; an arc
    touches about Q * slots = 128 of them. So each utterance gathers
    its rows of the packed (M, 2D) block and takes one (T, 2D) @ (2D,
    Q * slots) product, all of them one `torch.bmm`."""
    B, T = feats.shape[:2]
    Q, slots = st_mix.shape[1:]
    Wt, c = pack_gaussians(means, variances, gconsts)  # (2D, M), (M,)
    idx = st_mix.clamp(min=0).reshape(B, Q * slots)
    Wg = Wt.T[idx]  # (B, Q*slots, 2D): a row gather
    featx = torch.cat([feats * feats, feats], dim=-1)  # (B, T, 2D)
    with matmul_precision(precision):
        quad = torch.bmm(featx, Wg.transpose(1, 2))  # (B, T, Q*slots)
    return (-0.5 * (quad + c[idx][:, None, :])).reshape(B, T, Q, slots)


def _fb_outp(feats, comp_state, q_mask, *, means, variances, gconsts,
             state_mix, state_logw, state_sw=None, slot_blocks=None,
             precision: str = "highest", gather_outp: bool = False):
    """Observation log-likelihoods of the states each utterance touches.

    Returns (outp (B, T, Q), the per-slot scores gathered (B, T, Q,
    n_slots) and the per-stream b_js list, each (B, T, Q)); padded states
    have LZERO outp. `gather_outp` scores only the Gaussians each
    composite touches (`_gathered_mix_scores`), else all M are scored."""
    B, T = feats.shape[:2]
    Q = comp_state.shape[1]
    maxmix = state_mix.shape[1]
    blocks = list(slot_blocks) if slot_blocks else [(0, maxmix)]
    cs = comp_state.long()
    st_mix = state_mix[cs]  # (B, Q, n_slots)
    if gather_outp:
        gathered = _gathered_mix_scores(feats, st_mix, means, variances,
                                        gconsts, precision=precision)
    else:
        Wt, c = pack_gaussians(means, variances, gconsts)
        mix_lp = mix_scores(feats, Wt, c, precision=precision)  # (B, T, M)
        idx = st_mix.clamp(min=0).reshape(B, 1, Q * maxmix).expand(
            B, T, Q * maxmix)
        gathered = torch.gather(mix_lp, 2, idx).reshape(B, T, Q, maxmix)
        del mix_lp
    weighted = torch.where((st_mix >= 0)[:, None],
                           gathered + state_logw[cs][:, None], LZERO)
    # per-stream log b_js (unweighted) and the stream-weighted state outp
    b_stream = [ladd_reduce(weighted[..., j0:j1], dim=-1)
                for (j0, j1) in blocks]  # each (B, T, Q)
    if state_sw is None:
        outp = b_stream[0]
        for bs in b_stream[1:]:
            outp = outp + bs
    else:
        st_sw = state_sw[cs]  # (B, Q, n_slots)
        outp = None
        for (j0, _j1), bs in zip(blocks, b_stream):
            term = bs * st_sw[:, None, :, j0]
            outp = term if outp is None else outp + term
    outp = torch.where(q_mask[:, None, :], outp, LZERO).contiguous()
    return outp, gathered, b_stream


def _fb_core(feats, t_real, comp_state, q_mask, logA, a0, aE, *, means,
             variances, gconsts, state_mix, state_logw, state_sw=None,
             slot_blocks=None, precision: str = "highest",
             beam: Optional[float] = None, gather_outp: bool = False):
    """FB scans + occupancy moments for a batch, *pre-scatter*.

    feats (B, T, D), t_real (B,) int32, comp_state (B, Q) physical state
    ids (the trash row for padding), q_mask (B, Q), logA (B, Q, Q), a0/aE
    (B, Q); state tables carry the trailing trash row. Returns (logp (B,),
    occ_qm (B, Q, maxmix), sum_x_qm (B, Q*maxmix, D), sum_xx_qm, xi
    (B, Q, Q), entry_occ (B, Q), exit_occ (B, Q)).
    """
    B, T = feats.shape[:2]
    Q = comp_state.shape[1]
    maxmix = state_mix.shape[1]
    blocks = list(slot_blocks) if slot_blocks else [(0, maxmix)]
    cs = comp_state.long()
    st_mix = state_mix[cs]  # (B, Q, n_slots)
    st_logw = state_logw[cs]
    live = (st_mix >= 0)[:, None]  # (B, 1, Q, n_slots)

    # 1. observation likelihoods for the states each utterance touches
    outp, gathered, b_stream = _fb_outp(
        feats, comp_state, q_mask, means=means, variances=variances,
        gconsts=gconsts, state_mix=state_mix, state_logw=state_logw,
        state_sw=state_sw, slot_blocks=slot_blocks, precision=precision,
        gather_outp=gather_outp)

    # 2. scans: the CUDA kernel on the card, the plain scans on the CPU
    alphas, betas, logp, xi = _scans.fb_scans(
        outp, logA.contiguous(), a0.contiguous(), aE.contiguous(),
        t_real.to(torch.int32).contiguous(), beam)
    last = (t_real.long() - 1).clamp(min=0)
    alpha_last = alphas[torch.arange(B, device=feats.device), last]
    t_mask = (torch.arange(T, device=feats.device)[None, :]
              < t_real[:, None]).to(feats.dtype)

    # 3. state/mixture occupancies: within each stream the slot posterior
    # normalises by that stream's own b_js (HFB.c L_jsm semantics)
    gamma = alphas + betas - logp[:, None, None]  # (B, T, Q)
    if len(blocks) == 1:
        bnorm = b_stream[0][..., None]
    else:
        bnorm = torch.cat([bs[..., None].expand(B, T, Q, j1 - j0)
                           for (j0, j1), bs in zip(blocks, b_stream)], dim=3)
    l_log = gamma[..., None] + st_logw[:, None] + gathered - bnorm
    l_log = torch.where(live, l_log, LZERO)
    L = exp_or_zero(l_log) * t_mask[:, :, None, None]  # (B, T, Q, n_slots)

    occ_qm = L.sum(dim=1)  # (B, Q, maxmix)
    LfT = L.reshape(B, T, Q * maxmix).transpose(1, 2)
    with matmul_precision(precision):
        sum_x_qm = torch.matmul(LfT, feats)  # (B, Q*maxmix, D)
        sum_xx_qm = torch.matmul(LfT, feats * feats)

    # 4. transition posteriors at the utterance ends
    lp = logp[:, None]
    entry_occ = exp_or_zero(a0 + outp[:, 0] + betas[:, 0] - lp)  # (B, Q)
    exit_occ = exp_or_zero(alpha_last + aE - lp)
    return logp, occ_qm, sum_x_qm, sum_xx_qm, xi, entry_occ, exit_occ


def _segment_sum(values, seg, n):
    """Sum rows of `values` into n + 1 segments (the last one a sink for
    ids that accumulate nowhere) and drop the sink."""
    out = values.new_zeros((n + 1,) + tuple(values.shape[1:]))
    return out.index_add_(0, seg.reshape(-1).long(), values)[:n]


def fb_batch(feats, t_real, comp_state, q_mask, logA, a0, aE, tr_seg,
             entry_seg, exit_seg, weights=None, *, means, variances, gconsts,
             state_mix, state_logw, n_states: int, tr_flat: int,
             state_sw=None, slot_blocks=None, precision: str = "highest",
             beam: Optional[float] = None, gather_outp: bool = False):
    """Forward-backward over a padded utterance batch.

    `weights` (B,) scales each utterance's accumulators (MMI's lattice
    arc posteriors); `gather_outp` scores only the Gaussians each
    composite touches. `beam` enables HFB beta-beam pruning, shared by
    the whole batch.
    Returns (per-utterance logP (B,), summed Accumulators). The scatter
    onto the physical accumulators runs once over the flattened
    (B*Q*maxmix) batch; its sums come in another order than the JAX
    package's segment_sum, so the two agree to rounding.
    """
    logps, occ_qm, sum_x_qm, sum_xx_qm, xi, entry_occ, exit_occ = _fb_core(
        feats, t_real, comp_state, q_mask, logA, a0, aE, means=means,
        variances=variances, gconsts=gconsts, state_mix=state_mix,
        state_logw=state_logw, state_sw=state_sw, slot_blocks=slot_blocks,
        precision=precision, beam=beam, gather_outp=gather_outp)
    S = n_states
    maxmix = state_mix.shape[1]
    M = means.shape[0]
    D2 = sum_x_qm.shape[-1]
    cs = comp_state.long()

    # drop failed utterances AND all-padding rows (t_real == 0)
    ok = ((logps > LZERO / 2) & (t_real > 0)).to(feats.dtype)
    w = ok if weights is None else ok * weights  # (B,)
    w3 = w[:, None, None]

    st_mix = state_mix[cs]  # (B, Q, maxmix)
    flat_mix = torch.where(st_mix >= 0, st_mix, M)
    occ_w = occ_qm * w3  # (B, Q, maxmix)
    occ = _segment_sum(occ_w.reshape(-1), flat_mix, M)
    sum_x = _segment_sum((sum_x_qm * w3).reshape(-1, D2), flat_mix, M)
    sum_xx = _segment_sum((sum_xx_qm * w3).reshape(-1, D2), flat_mix, M)

    state_seg = torch.where(q_mask & (cs < S), cs, S)  # (B, Q)
    wt_occ = _segment_sum(occ_w.reshape(-1, maxmix), state_seg, S)

    within = (tr_seg >= 0).to(feats.dtype)  # (B, Q, Q)
    xi_w = xi * w3
    tr_within = _segment_sum(xi_w.reshape(-1),
                             torch.where(tr_seg >= 0, tr_seg, tr_flat),
                             tr_flat)
    cross = xi_w * (1.0 - within)
    cross_in = cross.sum(dim=1) + entry_occ * w[:, None]  # (B, Q)
    cross_out = cross.sum(dim=2) + exit_occ * w[:, None]
    tr_entry = _segment_sum(cross_in.reshape(-1),
                            torch.where(entry_seg >= 0, entry_seg, tr_flat),
                            tr_flat)
    tr_exit = _segment_sum(cross_out.reshape(-1),
                           torch.where(exit_seg >= 0, exit_seg, tr_flat),
                           tr_flat)
    summed = Accumulators(
        occ=occ, sum_x=sum_x, sum_xx=sum_xx, wt_occ=wt_occ,
        tr=tr_within + tr_entry + tr_exit,
        total_logp=torch.sum(logps * ok),
        total_frames=torch.sum(t_real.to(torch.float32) * ok),
        n_utts=torch.sum(ok))
    return logps, summed


def mix_posteriors_utterance(feats, t_real, comp_state, q_mask, logA, a0,
                             aE, *, means, variances, gconsts, state_mix,
                             state_logw, state_sw=None, slot_blocks=None,
                             precision: str = "highest"):
    """Per-frame physical-Gaussian posteriors gamma (T, M) of one
    utterance, the statistics of speaker adaptation (HERest -K): the
    front half of the forward-backward pass, as in the reference
    (htk_tpu/algo/fb.py : mix_posteriors_utterance).

    feats (T, D), t_real (), the composite's comp_state (Q,), q_mask (Q,),
    logA (Q, Q), a0/aE (Q,); the state tables carry the trailing trash
    row. OutP comes from `_fb_outp`, the scans from one `fb_scans` launch
    (the kernel on the card; no beam, as the reference has none), and the
    slot posteriors normalise by their own stream's b_js before one
    `index_add_` scatters them onto the M physical Gaussians. Returns
    (logP (), gamma (T, M)); frames at t >= t_real are zero."""
    T = feats.shape[0]
    M = means.shape[0]
    maxmix = state_mix.shape[1]
    Q = comp_state.shape[0]
    blocks = list(slot_blocks) if slot_blocks else [(0, maxmix)]
    t_real = t_real.reshape(1).to(torch.int32)
    outp, gathered, b_stream = _fb_outp(
        feats[None], comp_state[None], q_mask[None], means=means,
        variances=variances, gconsts=gconsts, state_mix=state_mix,
        state_logw=state_logw, state_sw=state_sw, slot_blocks=slot_blocks,
        precision=precision)
    alphas, betas, logp, _xi = _scans.fb_scans(
        outp, logA[None].contiguous(), a0[None].contiguous(),
        aE[None].contiguous(), t_real.contiguous(), None)
    cs = comp_state.long()
    st_mix = state_mix[cs]  # (Q, n_slots)
    gamma = (alphas + betas - logp[:, None, None])[0]  # (T, Q)
    if len(blocks) == 1:
        bnorm = b_stream[0][0][..., None]
    else:
        bnorm = torch.cat([bs[0][..., None].expand(T, Q, j1 - j0)
                           for (j0, j1), bs in zip(blocks, b_stream)], dim=2)
    l_log = gamma[..., None] + state_logw[cs][None] + gathered[0] - bnorm
    l_log = torch.where((st_mix >= 0)[None], l_log, LZERO)
    t_mask = (torch.arange(T, device=feats.device) < t_real).to(feats.dtype)
    L = exp_or_zero(l_log) * t_mask[:, None, None]  # (T, Q, n_slots)
    flat_mix = torch.where(st_mix >= 0, st_mix, M).reshape(-1)
    gamma_m = L.new_zeros((M + 1, T)).index_add_(
        0, flat_mix.long(), L.reshape(T, Q * maxmix).T)
    return logp[0], gamma_m[:M].T


def loglik_batch(feats, t_real, comp_state, q_mask, logA, a0, aE, *, means,
                 variances, gconsts, state_mix, state_logw, state_sw=None,
                 slot_blocks=None, precision: str = "highest",
                 gather_outp: bool = False):
    """Forward-pass log-likelihoods (B,) only, no accumulation: the cheap
    first pass of MMI arc scoring, as batched torch ops. HMMIRest's
    ArcFB takes the same logP from one fb_scans launch a bucket."""
    outp, _g, _bs = _fb_outp(
        feats, comp_state, q_mask, means=means, variances=variances,
        gconsts=gconsts, state_mix=state_mix, state_logw=state_logw,
        state_sw=state_sw, slot_blocks=slot_blocks, precision=precision,
        gather_outp=gather_outp)
    alphas = forward_scan(outp, logA, a0, t_real)
    last = (t_real.long() - 1).clamp(min=0)
    alpha_last = alphas[torch.arange(feats.shape[0], device=feats.device),
                        last]
    return ladd_reduce(alpha_last + aE, dim=-1)


def loglik_utterance(feats, t_real, comp_state, q_mask, logA, a0, aE,
                     **kw):
    """`loglik_batch` of one utterance: feats (T, D), t_real (), the
    composite's (Q,) and (Q, Q) tensors; returns logP ()."""
    return loglik_batch(feats[None], t_real.reshape(1), comp_state[None],
                        q_mask[None], logA[None], a0[None], aE[None],
                        **kw)[0]
