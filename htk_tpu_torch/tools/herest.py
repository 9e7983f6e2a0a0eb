"""HERest — embedded Baum-Welch reestimation, in torch.

The PyTorch counterpart of `htk_tpu/tools/herest.py` (`HTKTools/HERest.c`):
one invocation performs one reestimation iteration over the corpus — load
HMMs, forward-backward every utterance against its transcription on the
device (the HFB scans are the hand-written CUDA kernel on the card),
accumulate, update, save. Parallel modes:

  -p N (N>0)   accumulate this shard only, dump HERN.acc, don't update
  -p 0         load accumulator files given after the HMM list, update
  (default)    accumulate + update in one process, on one device

Usage: python -m htk_tpu_torch.tools.herest [options] hmmList [accFiles...]

  -H mmf   load HMM macro file (repeatable)     -M dir  output directory
  -I mlf   load master label file (repeatable)  -L dir  label dir
  -X ext   label extension (default lab)        -u tmvw update flags
  -t f [i l]  forward-backward pruning beam: beta values below the
           frame's best by more than f die, and the alpha pass is
           confined to the surviving band (HFB.c semantics). An
           utterance with no surviving path re-runs with the beam
           widened by i up to l, then is skipped with a warning. The
           beam is an argument of the scans: escalation rebuilds nothing
  -p N     parallel mode (above)                -v f    minimum variance
  -w f     mixture weight floor (accepted)      -s file write stats file
  -b n     utterances per FB batch (default 8)  -B      binary MMF output
  -K dir   estimate adaptation transforms (HADAPT: TRANSKIND = MLLRMEAN,
           CMLLR or MLLRCOV; BLOCKS, BASECLASS, OCCTHRESH, MLLRVAR,
           NUMREGCLASSES) instead of updating models: one TMF per -h
           speaker, or global.tmf without -h
  -J dir   input transform directory (with -a)  -h mask speaker mask
  -a       apply input transforms during accumulation: CMLLR in feature
           space (fMLLR-SAT), MLLR mean/variance per speaker group in
           model space (each group accumulates against its adapted
           parameters; the canonical model updates from summed stats)
  Standard: -A -C -D -S -T -V

Config: HTKTPU: DEVICECOMPOSITE (default T: composites assembled on the
device from model ids; F: built on the host), HTKTPU: PRECISION,
HTKTPU: METRICS, HTKTPU: PROFILE, HMAP: MAPTAU (> 0: MAP mean update,
algo/adapt.map_update). The device is the CUDA card, or the CPU when
HTK_TPU_TORCH_DEVICE=cpu asks for it (tools/_common.py).

Transform estimation (-K) takes host-built composites: CMLLR and MLLRCOV
read each utterance's Gaussian posteriors (algo/fb.
mix_posteriors_utterance: one fb_scans launch an utterance, the kernel on
the card) and sum their statistics on the host in float64, as the
reference does; MLLRMEAN reads the Baum-Welch accumulators, summed again
per speaker when there is more than one.

Not yet ported, each refused with HError 2390: single-pass retraining
(-r), and FULLC and DISCRETE sets.
"""

from __future__ import annotations

import glob
import os
from typing import List

import numpy as np

import torch

from ..algo import adapt
from ..algo.fb import mix_posteriors_utterance
from ..algo.reestimate import UpdateFlags, reestimate
from ..algo.trainer import (DeviceCompositeTrainer, Trainer, pad_batch,
                            prepare_utterance, prepare_utterance_ids)
from ..io.mlf import MLF, find_labels
from ..io.mmf import load_hmm_list, load_mmf, save_mmf
from ..models.hmmset import compile_hmmset, write_back
from ..parallel.acc_files import dump_accs, load_accs, sum_accs
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, HRError
from ..utils.metrics import emit_metric, maybe_profile
from ._common import default_device, open_speech_file, outp_precision

USAGE = ("Usage: python -m htk_tpu_torch.tools.herest [options] hmmList "
         "[accFiles...]")

OPTS = {
    "H": Option("H", 1, "load MMF", repeatable=True),
    "M": Option("M", 1, "output directory"),
    "I": Option("I", 1, "load MLF", repeatable=True),
    "L": Option("L", 1, "label directory"),
    "X": Option("X", 1, "label extension"),
    "u": Option("u", 1, "update flags tmvw"),
    "t": Option("t", 1, "pruning beam(s) f [i l]", typ=float, greedy=True),
    "p": Option("p", 1, "parallel mode", typ=int),
    "v": Option("v", 1, "minimum variance", typ=float),
    "w": Option("w", 1, "mixture weight floor", typ=float),
    "s": Option("s", 1, "stats file"),
    "d": Option("d", 1, "hmm definition directory"),
    "b": Option("b", 1, "batch size", typ=int),
    "K": Option("K", 1, "output transform dir (estimate adaptation)"),
    "J": Option("J", 1, "input transform dir"),
    "a": Option("a", 0, "apply input transforms"),
    "h": Option("h", 1, "speaker mask"),
    "r": Option("r", 0, "single-pass retraining (paired script)"),
}

_NOT_PORTED = {"r": "single-pass retraining"}


def _not_ported(what: str):
    HError(2390, "HERest: %s is not yet ported to htk_tpu_torch", what)


def write_stats_file(path: str, comp, accs) -> None:
    """HERest -s stats file: per-HMM per-state occupancies (HHEd RO input).

    Format (HTK): index logicalName nUtts totalOcc then per-state occs.
    """
    state_occ = accs.wt_occ.cpu().numpy().sum(axis=1)
    n_utts = int(accs.n_utts.cpu())
    with open(path, "w") as f:
        for i, name in enumerate(comp.names):
            n = int(comp.model_nstates[i])
            occs = [state_occ[comp.model_states[i, k]] for k in range(n - 2)]
            f.write(f'{i + 1:4d} "{name}" {n_utts:10d} '
                    + " ".join(f"{o:10.2f}" for o in occs) + "\n")


def _prune_setting(ta):
    """HERest -t f [i l] as (init, inc, limit), or None."""
    if not ta.has("t"):
        return None
    v = ta.get("t")
    vs = [float(x) for x in (v if isinstance(v, tuple) else (v,))]
    if len(vs) == 2:
        # HERest.c reads inc and limit together — two values would
        # silently kill the retry ladder (inc with limit == init)
        HError(1021, "HERest: -t takes f or f i l (inc without limit "
                     "given)")
    prune = (vs[0], vs[1] if len(vs) > 1 else 0.0,
             vs[2] if len(vs) > 2 else vs[0])
    if ta.trace:
        print(f"HERest: FB beam pruning {prune[0]:.1f} "
              f"(inc {prune[1]:.1f}, limit {prune[2]:.1f})")
    return prune


def _input_transforms(ta):
    """-a -J: {speaker key: TMF} from every *.tmf under the -J
    directories, a multi-class TMF as its (name, xforms, class_to_xf,
    classes) tuple."""
    in_xfs = {}
    if not (ta.has("a") and ta.get_all("J")):
        return in_xfs
    for d in ta.get_all("J"):
        for tmf in sorted(glob.glob(os.path.join(d, "*.tmf"))):
            key = os.path.splitext(os.path.basename(tmf))[0]
            multi = adapt.load_tmf_classes(tmf)
            in_xfs[key] = multi if multi is not None else adapt.load_tmf(
                tmf)[1]
    if not in_xfs:
        HRError(7441, "HERest: -a but no TMFs under -J")
    return in_xfs


def _accumulate(ta, comp, prune, files, batch_size):
    """Forward-backward over the training files on the tool's device.

    Returns (accs, trainer, utts). With -a, each utterance's input
    transform applies: CMLLR to its features, MLLR by accumulating its
    speaker's group against the adapted means (and variances) through
    `write_back`, the base parameters restored afterwards."""
    cfg = ta.config
    device = default_device()
    if ta.trace:
        print(f"HERest: device {device}")
    mlfs = [MLF.load(p, cfg) for p in ta.get_all("I")]
    label_dir = ta.get("L")
    label_ext = ta.get("X", "lab")
    # device-side composite assembly is the default trainer path;
    # HTKTPU: DEVICECOMPOSITE = F restores host assembly. Transform
    # estimation (-K) needs the host composites.
    use_dev_comp = (cfg.bool_("DEVICECOMPOSITE", True, module="HTKTPU")
                    and not ta.has("K"))
    cls = DeviceCompositeTrainer if use_dev_comp else Trainer
    trainer = cls(comp, precision=outp_precision(cfg), prune=prune,
                  device=device)
    prep = prepare_utterance_ids if use_dev_comp else prepare_utterance
    in_xfs = _input_transforms(ta)
    spk_mask = ta.get("h")
    tagged = []  # (model-space speaker or None, utt)
    for fn in files:
        data, _period, _kind, e = open_speech_file(fn, cfg)
        tr = find_labels(e.logical, mlfs, label_dir, label_ext)
        names = [lab.name for lab in tr.labels]
        if not names:
            HRError(7325, "HERest: empty transcription for %s", e.logical)
            continue
        spk = None
        if in_xfs:
            spk = (adapt.speaker_from_mask(spk_mask, e.logical) if spk_mask
                   else next(iter(in_xfs)))
            xf = in_xfs.get(spk)
            if xf is None:
                HRError(7441, "HERest: no input transform for %s", spk)
                spk = None
            elif not isinstance(xf, tuple) and xf.kind == "CMLLR":
                data = xf.apply_to_features(data).astype(np.float32)
                spk = None  # feature-space transform: no model group
        tagged.append((spk, prep(comp, e.logical, data, names)))
    if not tagged:
        HError(7326, "HERest: no trainable utterances")
    utts = [u for _spk, u in tagged]

    model_groups = {}
    plain = []
    for spk, u in tagged:
        if spk is not None:
            model_groups.setdefault(spk, []).append(u)
        else:
            plain.append(u)
    with maybe_profile(cfg, "HERest"):
        if not model_groups:
            return (trainer.accumulate(utts, batch_size=batch_size,
                                       trace=ta.trace), trainer, utts)
        base_means = comp.means.copy()
        base_vars = comp.variances.copy()
        acc_list = []
        if plain:
            acc_list.append(trainer.accumulate(
                plain, batch_size=batch_size, trace=ta.trace))
        for spk, uset in model_groups.items():
            xf = in_xfs[spk]
            if isinstance(xf, tuple):
                _nm, xfs_l, c2x, classes = xf
                nv = (adapt.apply_mllr_classes_vars(comp, base_vars, xfs_l,
                                                    c2x, classes)
                      if any(x.var_scale is not None for x in xfs_l)
                      else None)
                write_back(comp, means=adapt.apply_mllr_classes(
                    comp, base_means, xfs_l, c2x, classes), variances=nv)
            else:
                write_back(comp, means=xf.apply_to_means(base_means),
                           variances=(xf.apply_to_vars(base_vars)
                                      if xf.var_scale is not None else None))
            acc_list.append(trainer.accumulate(
                uset, batch_size=batch_size, trace=ta.trace))
        write_back(comp, means=base_means, variances=base_vars)
    return sum_accs(acc_list), trainer, utts


def _gammas(comp, trainer, uset):
    """(utterance, its Gaussian posteriors (T, M) as float64 numpy) for
    each of `uset`: one `mix_posteriors_utterance` call an utterance on
    the trainer's device, at the set's current parameters."""
    params = trainer.params()
    blocks = tuple(comp.slot_blocks) or None
    for u in uset:
        arrs = {k: torch.as_tensor(v[0], device=trainer.device)
                for k, v in pad_batch([u], comp.n_states).items()}
        _lp, gam = mix_posteriors_utterance(
            arrs["feats"], arrs["t_real"], arrs["comp_state"],
            arrs["q_mask"], arrs["logA"], arrs["a0"], arrs["aE"],
            **params, slot_blocks=blocks, precision=trainer.precision)
        T = u.feats.shape[0]
        yield u, gam[:T].cpu().numpy()


def _sum_cmllr(tot, st):
    if tot is None:
        return st
    tot.G += st.G
    tot.k += st.k
    tot.beta += st.beta
    return tot


def _estimate_transforms(ta, hset, comp, trainer, utts, accs, batch_size):
    """HERest -K: one transform per speaker (-h mask; one "global"
    speaker without it), saved as TMFs; the models are unchanged."""
    cfg = ta.config
    kind = (cfg.str_("TRANSKIND", "MLLRMEAN", module="HADAPT")
            or "MLLRMEAN").upper()
    # HADAPT: BLOCKS — block-diagonal transform structure (HAdapt
    # BLOCKINFO): the standard guard against under-determined
    # full-matrix solves on sparse adaptation data (3 on _D_A
    # features keeps statics/deltas/accelerations separate)
    n_blocks = int(cfg.flt_("BLOCKS", 1.0, module="HADAPT"))
    out_xf_dir = ta.get("K")
    os.makedirs(out_xf_dir, exist_ok=True)
    mask = ta.get("h")
    groups = {}
    for u in utts:
        spk = adapt.speaker_from_mask(mask, u.name) if mask else "global"
        groups.setdefault(spk, []).append(u)

    def cmllr_from(uset):
        stats = None
        for u, gam in _gammas(comp, trainer, uset):
            stats = _sum_cmllr(stats, adapt.cmllr_stats_from_gammas(
                u.feats.astype(np.float64), gam, comp.means,
                comp.variances))
        return adapt.estimate_cmllr(stats, blocks=n_blocks)

    def mllrcov_from(uset):
        G = None
        beta = 0.0
        for u, gam in _gammas(comp, trainer, uset):
            g, b = adapt.mllrcov_stats_from_gammas(
                u.feats.astype(np.float64), gam, comp.means, comp.variances)
            G = g if G is None else G + g
            beta += b
        return adapt.estimate_mllrcov(G, beta)

    n_reg = cfg.int_("NUMREGCLASSES", 1, module="HADAPT") or 1
    # HHEd RC output (classes + regression tree) overrides on-the-fly
    # clustering when given; the tree enables occupancy back-off
    bc_path = cfg.str_("BASECLASS", None, module="HADAPT")
    bc_classes = None
    bc_tree = None
    if bc_path:
        _bc_name, bc_classes, bc_tree = adapt.load_baseclass(
            bc_path, hset=hset, comp=comp)
        if len(bc_classes) != comp.n_mix:
            HError(7460, "HERest: baseclass %s covers %d Gaussians, "
                   "set has %d", bc_path, len(bc_classes), comp.n_mix)
        n_reg = max(n_reg, int(bc_classes.max()) + 1)
    mllr_var = cfg.bool_("MLLRVAR", False, module="HADAPT") or False
    occ_thresh = cfg.flt_("OCCTHRESH", 700.0, module="HADAPT") or 700.0

    def spk_accs(uset):
        if len(groups) == 1:
            return accs
        return trainer.accumulate(uset, batch_size=batch_size)

    for spk, uset in groups.items():
        tmf_path = os.path.join(out_xf_dir, f"{spk}.tmf")
        if kind == "MLLRMEAN":
            sa = spk_accs(uset)
            if n_reg > 1:
                if bc_tree is not None:
                    classes = bc_classes
                    xfs, c2x = adapt.estimate_mllr_tree(
                        comp, sa, classes, bc_tree[0], bc_tree[1],
                        occ_thresh=occ_thresh, mllr_var=mllr_var)
                else:
                    classes = (bc_classes if bc_classes is not None
                               else adapt.build_regression_classes(
                                   comp, n_reg))
                    xfs, c2x = adapt.estimate_mllr_classes(comp, sa, classes)
                adapt.save_tmf_classes(tmf_path, spk, xfs, c2x, classes)
                if ta.trace:
                    print(f"HERest: {len(xfs)} regression-class "
                          f"transforms for {spk} -> {tmf_path}")
                continue
            xf = adapt.estimate_mllr_mean(comp, sa, blocks=n_blocks)
            if mllr_var:
                xf.var_scale = adapt.estimate_mllr_var(
                    comp, sa, xf.apply_to_means(comp.means))
        elif kind == "CMLLR":
            if n_reg > 1:
                classes = (bc_classes if bc_classes is not None
                           else adapt.build_regression_classes(comp, n_reg))
                C = int(classes.max()) + 1
                g_stats = None
                c_stats = [None] * C
                for u, gam in _gammas(comp, trainer, uset):
                    fx = u.feats.astype(np.float64)
                    g_stats = _sum_cmllr(g_stats, adapt.cmllr_stats_from_gammas(
                        fx, gam, comp.means, comp.variances))
                    for c in range(C):
                        gm = gam * (classes[None, :] == c)
                        if gm.sum() <= 0:
                            continue
                        c_stats[c] = _sum_cmllr(
                            c_stats[c], adapt.cmllr_stats_from_gammas(
                                fx, gm, comp.means, comp.variances))
                xfs, c2x = adapt.estimate_cmllr_classes(
                    c_stats, g_stats, occ_thresh=occ_thresh)
                adapt.save_tmf_classes(tmf_path, spk, xfs, c2x, classes,
                                       kind="CMLLRCLASSES")
                if ta.trace:
                    print(f"HERest: {len(xfs)} base-class CMLLR "
                          f"transforms for {spk} -> {tmf_path}")
                continue
            xf = cmllr_from(uset)
        elif kind == "MLLRCOV":
            xf = mllrcov_from(uset)
        else:
            HError(7450, "HERest: unsupported TRANSKIND %s", kind)
        adapt.save_tmf(tmf_path, spk, xf)
        if ta.trace:
            print(f"HERest: estimated {kind} transform for {spk} "
                  f"({len(uset)} utts) -> {tmf_path}")


def run(argv: List[str]) -> int:
    ta = parse_args("HERest", argv, OPTS, min_args=1, usage=USAGE)
    for opt, what in _NOT_PORTED.items():
        if ta.has(opt):
            _not_ported(f"-{opt} ({what})")
    prune = _prune_setting(ta)
    cfg = ta.config
    hmm_list_file = ta.args[0]
    extra = ta.args[1:]

    mmfs = ta.get_all("H")
    if not mmfs:
        HError(1030, "HERest: at least one -H mmf required\n%s", USAGE)
    hset = load_mmf(mmfs, cfg=cfg)
    hmm_list = load_hmm_list(hmm_list_file, cfg)
    missing = [l for l, p in hmm_list if (p or l) not in hset.hmms]
    if missing:
        HError(7035, "HERest: HMMs not in MMF: %s", " ".join(missing[:5]))
    comp = compile_hmmset(hset)
    if comp.full_cov:
        _not_ported("training a FULLC set")
    if comp.discrete:
        _not_ported("training a DISCRETE set")

    flags = UpdateFlags.parse(ta.get("u", "tmvw"))
    min_var = float(ta.get("v", 1e-6) or 1e-6)
    var_floor = hset.macros["v"].get("varFloor1")
    p_mode = int(ta.get("p", -1)) if ta.has("p") else -1
    out_dir = ta.get("M", ".")
    batch_size = int(ta.get("b", 8) or 8)

    if p_mode == 0:
        if ta.has("K"):
            HError(1030, "HERest: -K transform estimation needs utterance "
                         "mode, not -p 0 accumulator combining")
        if not extra:
            HError(1030, "HERest: -p 0 needs accumulator files")
        accs = sum_accs([load_accs(p) for p in extra])
    else:
        files = ta.script + extra
        if not files:
            HError(1030, "HERest: no training files\n%s", USAGE)
        accs, trainer, utts = _accumulate(ta, comp, prune, files,
                                          batch_size)
        if p_mode > 0:
            os.makedirs(out_dir, exist_ok=True)
            acc_path = os.path.join(out_dir, f"HER{p_mode}.acc")
            dump_accs(accs, acc_path)
            if ta.trace:
                print(f"HERest: dumped accumulators to {acc_path}")
            return 0

    tf = float(accs.total_frames.cpu())
    tl = float(accs.total_logp.cpu())
    nu = int(accs.n_utts.cpu())
    if ta.trace:
        print(f"Reestimation complete - average log prob per frame = "
              f"{tl / max(tf, 1.0):.5f} ({nu} utterances, {int(tf)} frames)")
    emit_metric(cfg, "HERest", logp_per_frame=tl / max(tf, 1.0),
                frames=int(tf), utterances=nu)

    if ta.has("K"):
        _estimate_transforms(ta, hset, comp, trainer, utts, accs,
                             batch_size)
        return 0
    map_tau = cfg.flt_("MAPTAU", 0.0, module="HMAP") or 0.0
    if map_tau > 0:
        write_back(comp, means=adapt.map_update(comp, accs, map_tau))
    else:
        m, v, w, t = reestimate(comp, accs, flags, var_floor=var_floor,
                                min_var=min_var)
        write_back(comp, means=m, variances=v, weights=w, transps=t)
    if ta.has("s"):
        write_stats_file(ta.get("s"), comp, accs)

    os.makedirs(out_dir, exist_ok=True)
    out_mmf = os.path.join(out_dir, os.path.basename(mmfs[0]))
    save_mmf(hset, out_mmf, binary=ta.binary)
    if ta.trace:
        print(f"HERest: saved {out_mmf}")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
