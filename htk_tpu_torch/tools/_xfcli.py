"""Shared -J/-h/-k input-transform CLI machinery (HVite and HDecode).

Mirrors the transform-loading half of `HTKLib/HAdapt.c` as the tools
drive it: -J directories are scanned for TMFs, the -h speaker mask
selects a per-speaker chain, and a "global" TMF acts as the parent
transform prefixed to every speaker's own chain.

Two application styles exist:
  - HVite mutates the compiled set in place per utterance (it also
    supports the full-covariance promotions — MLLRCOV, model-space
    CMLLR classes); that code stays in hvite.py.
  - HDecode computes NON-mutating per-speaker parameter overrides
    (`chain_model_params`) that ride the fused LV pipeline as traced
    operands, so one compiled executable serves every speaker. Chains
    that would promote the scorer to full covariance are refused with a
    numbered error (`HTKLVRec/HDecode.c` likewise supports the
    MLLR/CMLLR input-transform subset).

Copied from `htk_tpu/tools/_xfcli.py` into the PyTorch port: host numpy,
behaviour unchanged. In the port the per-speaker overrides are the
`model_params` of algo/decode, scored by a GaussianScorer of their own.
"""

from __future__ import annotations

import glob
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.errors import HError, HRError


def load_input_transforms(dirs: List[str], trace: int = 0,
                          tool: str = "HVite") -> Dict[str, list]:
    """Scan -J directories for *.tmf; returns {speaker_key: chain}.

    Multi-class TMFs load as (name, xfs, comp2xf, classes) tuples,
    single transforms as XForm objects (algo/adapt.py). Chains from
    repeated -J dirs compose left-to-right.
    """
    from ..algo.adapt import load_tmf, load_tmf_classes

    xforms: Dict[str, list] = {}
    for xf_dir in dirs:
        for tmf in sorted(glob.glob(os.path.join(xf_dir, "*.tmf"))):
            multi = load_tmf_classes(tmf)
            key = os.path.splitext(os.path.basename(tmf))[0]
            if multi is not None:
                xforms.setdefault(key, []).append(multi)
                if trace:
                    print(f"{tool}: loaded {len(multi[1])} regression-"
                          f"class transforms {tmf}")
                continue
            name, xf = load_tmf(tmf)
            xforms.setdefault(key, []).append(xf)
            if trace:
                print(f"{tool}: loaded {xf.kind} transform {tmf}")
    return xforms


def resolve_chain(xforms: Dict[str, list], spk_mask: Optional[str],
                  logical: str, tool: str = "HVite") -> list:
    """Select the transform chain for an utterance.

    With -h: the mask resolves the speaker; a "global" entry prefixes
    every speaker's own chain (HAdapt parent-transform chaining). A
    speaker with no TMF falls back to global alone (warning). Without
    -h: the single loaded chain applies to everything.
    """
    if not xforms:
        return []
    from ..algo.adapt import speaker_from_mask

    if spk_mask:
        spk = speaker_from_mask(spk_mask, logical)
        spk_chain = xforms.get(spk)
        if spk_chain is None:
            chain = xforms.get("global")
            if chain is None:
                HRError(7441, "%s: no transform for speaker %s", tool, spk)
                chain = []
            return list(chain)
        return (list(xforms.get("global", []))
                if spk != "global" else []) + list(spk_chain)
    return next(iter(xforms.values()))


def recomputed_gconsts(comp, variances: np.ndarray) -> np.ndarray:
    """Per-mixture gConsts for overridden diagonal variances (the
    write_back formula, without mutating the set)."""
    ms = (comp.mix_stream if comp.mix_stream is not None
          else np.zeros(len(comp._mix_objs), np.int32))
    gc = np.empty(variances.shape[0], np.float64)
    for i in range(variances.shape[0]):
        d0, d1 = (comp.stream_slices[int(ms[i])] if comp.stream_slices
                  else (0, comp.dim))
        gc[i] = ((d1 - d0) * math.log(2 * math.pi)
                 + np.sum(np.log(np.maximum(
                     variances[i, d0:d1].astype(np.float64), 1e-38))))
    return gc.astype(np.float32)


def chain_feature_data(chain: list, data: np.ndarray) -> np.ndarray:
    """Apply only the feature-space (CMLLR) legs of a transform chain.

    The model-space legs are data-independent, so callers that cache
    per-speaker parameter overrides (chain_model_params output) apply
    this to each further utterance instead of re-deriving the params."""
    for xf in chain:
        if not isinstance(xf, tuple) and xf.kind not in ("MLLRMEAN",
                                                         "MLLRCOV"):
            data = xf.apply_to_features(data).astype(data.dtype)
    return data


def chain_model_params(
    comp, chain: list, data: np.ndarray,
    base: Tuple[np.ndarray, np.ndarray],
    tool: str = "HDecode",
) -> Tuple[np.ndarray, Optional[dict]]:
    """Apply a transform chain without mutating the compiled set.

    Feature-space CMLLR transforms apply to `data`; model-space
    transforms produce parameter overrides {means, variances, gconsts}
    for the decode pipelines. Returns (data, params|None). Chains that
    would promote the scorer to full covariance (MLLRCOV, model-space
    CMLLR classes) raise a numbered error — use HVite for those.
    """
    if not chain:
        return data, None
    from ..algo.adapt import apply_mllr_classes, apply_mllr_classes_vars

    if comp.full_cov:
        HError(7450, "%s: input transforms on full-covariance sets are "
                     "not supported here — decode with HVite", tool)
    base_m, base_v = base
    cur_m, cur_v = base_m, base_v
    model_touched = False
    vars_touched = False
    for xf in chain:
        if isinstance(xf, tuple):  # regression-class set
            _nm, xfs, c2x, classes = xf
            if xfs and xfs[0].kind == "CMLLR":
                HError(7450, "%s: model-space CMLLR class transforms "
                             "promote to full covariance — decode with "
                             "HVite", tool)
            if any(x.var_scale is not None for x in xfs):
                cur_v = apply_mllr_classes_vars(comp, cur_v, xfs, c2x,
                                                classes)
                vars_touched = True
            cur_m = apply_mllr_classes(comp, cur_m, xfs, c2x, classes)
            model_touched = True
        elif xf.kind == "MLLRMEAN":
            cur_m = xf.apply_to_means(cur_m)
            model_touched = True
            if xf.var_scale is not None:
                cur_v = xf.apply_to_vars(cur_v)
                vars_touched = True
        elif xf.kind == "MLLRCOV":
            HError(7450, "%s: MLLRCOV (full variance transform) is not "
                         "supported here — decode with HVite", tool)
        else:  # CMLLR: feature space
            data = xf.apply_to_features(data).astype(data.dtype)
    if not model_touched and not vars_touched:
        return data, None
    gc = (recomputed_gconsts(comp, cur_v) if vars_touched
          else comp.gconsts)
    return data, {
        "means": np.asarray(cur_m, np.float32),
        "variances": np.asarray(cur_v, np.float32),
        "gconsts": np.asarray(gc, np.float32),
    }
