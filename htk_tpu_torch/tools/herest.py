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
  Standard: -A -C -D -S -T -V

Config: HTKTPU: DEVICECOMPOSITE (default T: composites assembled on the
device from model ids; F: built on the host), HTKTPU: PRECISION,
HTKTPU: METRICS, HTKTPU: PROFILE. The device is the CUDA card, or the CPU
when HTK_TPU_TORCH_DEVICE=cpu asks for it (tools/_common.py).

Not yet ported, each refused with HError 2390: single-pass retraining
(-r), input transforms and adaptation (-a, -J, -K, -h), FULLC and
DISCRETE sets, and MAP updates (HMAP: MAPTAU > 0).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..algo.reestimate import UpdateFlags, reestimate
from ..algo.trainer import (DeviceCompositeTrainer, Trainer,
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

_NOT_PORTED = {
    "r": "single-pass retraining",
    "a": "input transforms",
    "J": "input transforms",
    "K": "adaptation transform estimation",
    "h": "speaker masks",
}


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


def _accumulate(ta, comp, prune, files, batch_size):
    """Forward-backward over the training files on the tool's device."""
    cfg = ta.config
    device = default_device()
    if ta.trace:
        print(f"HERest: device {device}")
    mlfs = [MLF.load(p, cfg) for p in ta.get_all("I")]
    label_dir = ta.get("L")
    label_ext = ta.get("X", "lab")
    # device-side composite assembly is the default trainer path;
    # HTKTPU: DEVICECOMPOSITE = F restores host assembly
    use_dev_comp = cfg.bool_("DEVICECOMPOSITE", True, module="HTKTPU")
    cls = DeviceCompositeTrainer if use_dev_comp else Trainer
    trainer = cls(comp, precision=outp_precision(cfg), prune=prune,
                  device=device)
    prep = prepare_utterance_ids if use_dev_comp else prepare_utterance
    utts = []
    for fn in files:
        data, _period, _kind, e = open_speech_file(fn, cfg)
        tr = find_labels(e.logical, mlfs, label_dir, label_ext)
        names = [lab.name for lab in tr.labels]
        if not names:
            HRError(7325, "HERest: empty transcription for %s", e.logical)
            continue
        utts.append(prep(comp, e.logical, data, names))
    if not utts:
        HError(7326, "HERest: no trainable utterances")
    with maybe_profile(cfg, "HERest"):
        return trainer.accumulate(utts, batch_size=batch_size,
                                  trace=ta.trace)


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
    if (cfg.flt_("MAPTAU", 0.0, module="HMAP") or 0.0) > 0:
        _not_ported("MAP updating (HMAP: MAPTAU > 0)")

    flags = UpdateFlags.parse(ta.get("u", "tmvw"))
    min_var = float(ta.get("v", 1e-6) or 1e-6)
    var_floor = hset.macros["v"].get("varFloor1")
    p_mode = int(ta.get("p", -1)) if ta.has("p") else -1
    out_dir = ta.get("M", ".")
    batch_size = int(ta.get("b", 8) or 8)

    if p_mode == 0:
        if not extra:
            HError(1030, "HERest: -p 0 needs accumulator files")
        accs = sum_accs([load_accs(p) for p in extra])
    else:
        files = ta.script + extra
        if not files:
            HError(1030, "HERest: no training files\n%s", USAGE)
        accs = _accumulate(ta, comp, prune, files, batch_size)
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
