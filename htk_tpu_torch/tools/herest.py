"""HERest — embedded Baum-Welch reestimation, in torch.

The PyTorch counterpart of `htk_tpu/tools/herest.py` (`HTKTools/HERest.c`):
one invocation performs one reestimation iteration over the corpus — load
HMMs, forward-backward every utterance against its transcription on the
device (the HFB scans are the hand-written CUDA kernel on the card),
accumulate, update, save. Parallel modes:

  -p N (N>0)   accumulate this shard only, dump HERN.acc, don't update
  -p 0         load accumulator files given after the HMM list, update
  (default)    accumulate + update in one process, on one device

Across ranks (HTK's -p N jobs as one program): run one process a rank
under torchrun (`python -m torch.distributed.run --nproc_per_node N -m
htk_tpu_torch.tools.herest ...`), or give every process WORLD_SIZE and
RANK and `HTKTPU: COORDINATOR = tcp://host:port` (or `file://path`).
Every rank reads the script; with host-built composites (HTKTPU:
DEVICECOMPOSITE = F, or -K) and HTKTPU: USESHARDING true (the default),
each FB batch is sharded across the ranks and its accumulators summed by
one all_reduce (parallel/mesh.py ShardedTrainer); each rank runs on its
own card (LOCAL_RANK). Every rank updates from the same sums; only rank 0
prints the trace and writes the MMF, -s statistics, .acc files, TMFs and
metrics, and the ranks meet at a barrier before they exit.

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
  -r       single-pass retraining: the script pairs files ("old new" on
           one line, or alternating lines); occupancies are aligned on
           channel 1 (config HPARM1:/HWAVE1: overrides), moment stats
           accumulate from channel 2 (HPARM2:/HWAVE2:), and the updated
           means/variances take channel 2's width and parm kind
  Standard: -A -C -D -S -T -V

Config: HTKTPU: DEVICECOMPOSITE (default T: composites assembled on the
device from model ids; F: built on the host), HTKTPU: PRECISION,
HTKTPU: METRICS, HTKTPU: PROFILE, HTKTPU: COORDINATOR and USESHARDING
(above), HMAP: MAPTAU (> 0: MAP mean update, algo/adapt.map_update).
The device is the CUDA card, or the CPU when HTK_TPU_TORCH_DEVICE=cpu
asks for it (tools/_common.py).

Transform estimation (-K) takes host-built composites: CMLLR and MLLRCOV
read each utterance's Gaussian posteriors (algo/fb.
mix_posteriors_utterance: one fb_scans launch an utterance, the kernel on
the card) and sum their statistics on the host in float64, as the
reference does; MLLRMEAN reads the Baum-Welch accumulators, summed again
per speaker when there is more than one.

FULLC sets train an utterance at a time (algo/fullcov_train.py: two
fb_scans launches an utterance, the second moments summed on the host in
float64; -p N writes them beside the .acc as HER<N>.acc.fcx.npy, which
-p 0 reads); DISCRETE sets in batches through algo/fb_discrete.py's
DiscreteTrainer (one fb_scans launch a batch). -t applies to
continuous-density diagonal sets only: FULLC and DISCRETE sets
accumulate exactly. -r runs the host-composite Trainer with the second
channel (one fb_scans launch a batch).
"""

from __future__ import annotations

import glob
import os
from typing import Any, List, NamedTuple, Optional

import numpy as np

import torch
import torch.distributed as dist

from ..algo import adapt
from ..algo.fb import mix_posteriors_utterance
from ..algo.fb_discrete import DiscreteTrainer, reestimate_discrete
from ..algo.fullcov_train import fullcov_accumulate, fullcov_update
from ..algo.reestimate import UpdateFlags, reestimate, retrain_params
from ..algo.trainer import (DeviceCompositeTrainer, Trainer, pad_batch,
                            prepare_utterance, prepare_utterance_ids)
from ..io import parmkind as pk
from ..io.mlf import MLF, find_labels
from ..io.mmf import load_hmm_list, load_mmf, save_mmf
from ..models.hmmset import (compile_hmmset, write_back,
                             write_back_discrete, write_back_retrained)
from ..parallel.acc_files import dump_accs, load_accs, sum_accs
from ..parallel.mesh import ShardedTrainer, init_distributed, make_mesh
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, HRError
from ..utils.metrics import emit_metric, maybe_profile
from ._common import (channel_config, default_device, open_speech_file,
                      outp_precision, preload_corpus)

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

def _writer() -> bool:
    """Whether this process writes the tool's files: a single process, or
    rank 0 of a group."""
    return not dist.is_initialized() or dist.get_rank() == 0


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


def _input_transforms(ta, comp):
    """-a -J: {speaker key: TMF} from every *.tmf under the -J
    directories, a multi-class TMF as its (name, xforms, class_to_xf,
    classes) tuple; none for a discrete set."""
    in_xfs = {}
    if not (ta.has("a") and ta.get_all("J")) or comp.discrete:
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


def _pair_script(files):
    """HERest -r's paired script: "old new" on one line, or alternating
    lines; returns [(old, new)]."""
    paired = []
    pend = None
    for fn in files:
        toks = fn.split()
        if len(toks) == 2:
            paired.append((toks[0], toks[1]))
        elif pend is None:
            pend = fn
        else:
            paired.append((pend, fn))
            pend = None
    if pend is not None:
        HError(1030, "HERest: -r script has an unpaired file %s", pend)
    return paired


class Pass(NamedTuple):
    """One accumulation pass's results: the accumulators, the trainer
    (None for FULLC sets), the prepared utterances, a FULLC set's second
    moments (M, D, D) and -r's channel-2 parm kind."""

    accs: Any
    trainer: Any
    utts: list
    fc_xxT: Optional[np.ndarray] = None
    kind2: Optional[int] = None


def _accumulate(ta, comp, prune, files, batch_size) -> Pass:
    """Forward-backward over the training files on the tool's device.

    With -a, each utterance's input transform applies: CMLLR to its
    features, MLLR by accumulating its speaker's group against the
    adapted means (and variances) through `write_back`, the base
    parameters restored afterwards. With -r, each utterance carries its
    pair's second channel."""
    cfg = ta.config
    device = default_device()
    if ta.trace:
        print(f"HERest: device {device}")
    mlfs = [MLF.load(p, cfg) for p in ta.get_all("I")]
    label_dir = ta.get("L")
    label_ext = ta.get("X", "lab")
    retrain = ta.has("r")
    if comp.full_cov and (retrain or ta.has("a")):
        HError(7060, "HERest: full-covariance training combines with "
                     "neither -r nor -a input transforms (-K MLLRMEAN "
                     "estimation is supported)")
    if retrain and comp.discrete:
        HError(7060, "HERest: -r single-pass retraining needs a "
                     "continuous-density set")
    if retrain and ta.has("a"):
        HError(1030, "HERest: -r cannot combine with -a input transforms")
    # device-side composite assembly is the default trainer path;
    # HTKTPU: DEVICECOMPOSITE = F restores host assembly. Transform
    # estimation (-K), -r and the FULLC and DISCRETE trainers need the
    # host composites.
    use_dev_comp = (cfg.bool_("DEVICECOMPOSITE", True, module="HTKTPU")
                    and not (ta.has("K") or retrain or comp.discrete
                             or comp.full_cov))
    pairs = {}
    kind2 = None
    if retrain:
        paired = _pair_script(files)
        files = [a for a, _b in paired]
        pairs = dict(paired)
        cfg1, cfg2 = channel_config(cfg, 1), channel_config(cfg, 2)
        # channel-2 width: open the first pair's second file
        d2_probe, _p2, kind2, _e2 = open_speech_file(paired[0][1], cfg2)
    if prune is not None and (comp.full_cov or comp.discrete):
        if ta.trace:
            print("HERest: -t applies to continuous-density scan training "
                  "only — accumulating exactly")
        prune = None
    prec = outp_precision(cfg)
    if comp.full_cov:
        trainer = None  # algo/fullcov_train, an utterance at a time
    elif comp.discrete:
        trainer = DiscreteTrainer(comp, device=device)
    elif retrain:
        trainer = Trainer(comp, precision=prec, prune=prune, device=device,
                          retrain_dim=int(d2_probe.shape[1]))
    elif use_dev_comp:
        trainer = DeviceCompositeTrainer(comp, precision=prec, prune=prune,
                                         device=device)
    else:
        trainer = _make_trainer(comp, cfg, prune, device)
    if (ta.trace and dist.is_initialized() and dist.get_world_size() > 1
            and not isinstance(trainer, ShardedTrainer)):
        print(f"HERest: {dist.get_world_size()} ranks, each accumulating "
              f"every utterance (sharding takes HTKTPU: DEVICECOMPOSITE = "
              f"F and USESHARDING = T, and a continuous-density set "
              f"without -r)")
    prep = prepare_utterance_ids if use_dev_comp else prepare_utterance
    in_xfs = _input_transforms(ta, comp)
    spk_mask = ta.get("h")
    tagged = []  # (model-space speaker or None, utt)
    pre = {} if retrain else preload_corpus(files, cfg)
    for fn in files:
        data2 = None
        if retrain:
            data, _p, _k, e = open_speech_file(fn, cfg1)
            data2, _p2, kind2, _e2 = open_speech_file(pairs[fn], cfg2)
            if data2.shape[0] != data.shape[0]:
                n = min(data.shape[0], data2.shape[0])
                HRError(7327, "HERest -r: %s/%s frame counts differ (%d vs "
                        "%d), clipping", fn, pairs[fn], data.shape[0],
                        data2.shape[0])
                data, data2 = data[:n], data2[:n]
        else:
            data, _period, _kind, e = (pre.get(fn)
                                       or open_speech_file(fn, cfg))
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
        tagged.append((spk, prepare_utterance(comp, e.logical, data, names,
                                              feats2=data2)
                           if retrain else prep(comp, e.logical, data,
                                                names)))
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
        if comp.full_cov:
            accs, fc_xxT = fullcov_accumulate(comp, utts, trace=ta.trace,
                                              device=device)
            return Pass(accs, None, utts, fc_xxT=fc_xxT)
        if not model_groups:
            return Pass(trainer.accumulate(utts, batch_size=batch_size,
                                           trace=ta.trace), trainer, utts,
                        kind2=kind2)
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
    return Pass(sum_accs(acc_list), trainer, utts)


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
    write = _writer()
    if write:
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
    if comp.full_cov and (kind != "MLLRMEAN" or mllr_var):
        HError(7450, "HERest -K: full-covariance sets estimate MLLRMEAN "
                     "mean transforms only (TRANSKIND %s%s)", kind,
               ", MLLRVAR" if mllr_var else "")

    def spk_accs(uset):
        if len(groups) == 1:
            return accs
        if comp.full_cov:
            return fullcov_accumulate(comp, uset, trace=ta.trace,
                                      device=default_device())[0]
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
                if write:
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
                if write:
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
        if write:
            adapt.save_tmf(tmf_path, spk, xf)
        if ta.trace:
            print(f"HERest: estimated {kind} transform for {spk} "
                  f"({len(uset)} utts) -> {tmf_path}")


def _retrain_kind(ta, kind2) -> int:
    """-r's channel-2 parm kind: the probed file's, or under -p 0
    config HPARM2: TARGETKIND."""
    if kind2 is None:
        k2s = channel_config(ta.config, 2).str_("TARGETKIND", None,
                                                module="HPARM")
        if not k2s or k2s.upper() == "ANON":
            HError(1030, "HERest -r -p 0: config HPARM2: TARGETKIND must "
                         "name the new channel's kind")
        kind2 = pk.str2parmkind(k2s)
    return int(kind2) & ~(pk.HASCOMPX | pk.HASCRCC)


def _save(ta, hset, out_dir, mmfs, what=""):
    if not _writer():
        return
    os.makedirs(out_dir, exist_ok=True)
    out_mmf = os.path.join(out_dir, os.path.basename(mmfs[0]))
    save_mmf(hset, out_mmf, binary=ta.binary)
    if ta.trace:
        print(f"HERest: saved {out_mmf}{what}")


def run(argv: List[str]) -> int:
    """HERest on this process, which joins its ranks' group first when one
    is configured (torchrun's variables, or HTKTPU: COORDINATOR)."""
    ta = parse_args("HERest", argv, OPTS, min_args=1, usage=USAGE)
    joined = dist.is_initialized()
    init_distributed(coordinator=ta.config.str_("COORDINATOR", None,
                                                module="HTKTPU"))
    try:
        if not _writer():
            ta.trace = 0
        rc = _herest(ta)
        if dist.is_initialized():
            dist.barrier()  # rank 0's files are written
        return rc
    finally:
        if not joined and dist.is_initialized():
            dist.destroy_process_group()


def _herest(ta) -> int:
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
        fc_xxT = kind2 = None
        if comp.full_cov:
            for p in extra:
                try:
                    side = np.load(p + ".fcx.npy")
                except OSError:
                    HError(7111, "HERest -p 0: FULLC set needs the "
                                 "second-moment sidecar %s.fcx.npy (dumped "
                                 "by the matching -p N run)", p)
                fc_xxT = side if fc_xxT is None else fc_xxT + side
    else:
        files = ta.script + extra
        if not files:
            HError(1030, "HERest: no training files\n%s", USAGE)
        ps = _accumulate(ta, comp, prune, files, batch_size)
        accs, fc_xxT, kind2 = ps.accs, ps.fc_xxT, ps.kind2
        if p_mode > 0:
            if not _writer():
                return 0
            os.makedirs(out_dir, exist_ok=True)
            acc_path = os.path.join(out_dir, f"HER{p_mode}.acc")
            dump_accs(accs, acc_path)
            if comp.full_cov:
                # full second moments ride a sidecar next to the .acc
                np.save(acc_path + ".fcx.npy", fc_xxT)
            if ta.trace:
                print(f"HERest: dumped accumulators to {acc_path}")
            return 0

    tf = float(accs.total_frames.cpu())
    tl = float(accs.total_logp.cpu())
    nu = int(accs.n_utts.cpu())
    if ta.trace:
        print(f"Reestimation complete - average log prob per frame = "
              f"{tl / max(tf, 1.0):.5f} ({nu} utterances, {int(tf)} frames)")
    if _writer():
        emit_metric(cfg, "HERest", logp_per_frame=tl / max(tf, 1.0),
                    frames=int(tf), utterances=nu)

    if ta.has("K"):
        _estimate_transforms(ta, hset, comp, ps.trainer, ps.utts, accs,
                             batch_size)
        return 0
    if comp.discrete:
        table, new_tr = reestimate_discrete(comp, accs)
        write_back_discrete(comp, table)
        if flags.transitions:
            write_back(comp, transps=new_tr)
        _save(ta, hset, out_dir, mmfs, " (discrete)")
        return 0
    map_tau = cfg.flt_("MAPTAU", 0.0, module="HMAP") or 0.0
    if comp.full_cov:
        comp, n_upd = fullcov_update(hset, comp, accs, fc_xxT, flags,
                                     min_var=min_var)
        if ta.trace:
            print(f"HERest: FULLC update touched {n_upd} Gaussians")
    elif ta.has("r"):
        # single-pass retraining update: weights/transitions from the
        # alignment statistics as usual; means/variances wholesale from
        # the channel-2 moment sums, the set takes channel 2's geometry
        kind2 = _retrain_kind(ta, kind2)
        _m, _v, w, t = reestimate(
            comp, accs, UpdateFlags(means=False, variances=False,
                                    weights=flags.weights,
                                    transitions=flags.transitions))
        write_back(comp, weights=w, transps=t)
        m2, v2, g_var = retrain_params(accs, min_var=min_var)
        write_back_retrained(comp, m2, v2, kind2, g_var=g_var)
    elif map_tau > 0:
        write_back(comp, means=adapt.map_update(comp, accs, map_tau))
    else:
        m, v, w, t = reestimate(comp, accs, flags, var_floor=var_floor,
                                min_var=min_var)
        write_back(comp, means=m, variances=v, weights=w, transps=t)
    if ta.has("s") and _writer():
        write_stats_file(ta.get("s"), comp, accs)
    _save(ta, hset, out_dir, mmfs)
    return 0


def _make_trainer(comp, cfg, prune, device) -> Trainer:
    """The host-composite trainer: ShardedTrainer over every rank when the
    process is one of a group of more than one and HTKTPU: USESHARDING is
    true (its default), the one-device Trainer otherwise."""
    prec = outp_precision(cfg)
    if (dist.is_initialized() and dist.get_world_size() > 1
            and cfg.bool_("USESHARDING", True, module="HTKTPU")):
        return ShardedTrainer(comp, make_mesh(device_type=device.type),
                              precision=prec, prune=prune, device=device)
    return Trainer(comp, precision=prec, prune=prune, device=device)


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
