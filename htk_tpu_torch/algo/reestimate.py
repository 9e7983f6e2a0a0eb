"""Parameter reestimation from Baum-Welch accumulators.

Mirrors `HTKTools/HERest.c : UpdateModels()` (+ HTrain.c accumulator
semantics): means/variances/weights/transitions update as pure functions
of the summed Accumulators, with HTK's guards — variance flooring,
defunct-mixture weight floor (MINMIX), and minimum-occupancy protection
(parameters keep their old values when a state/mixture saw too little
data, like HTK's minEgs/occ checks).

All update math runs in numpy float64 on host: the accumulators are tiny
compared to the FB pass, and f64 matches HTK's double-precision update
path exactly.

Copied from `htk_tpu/algo/reestimate.py` into the PyTorch port: numpy,
behaviour unchanged; the accumulators are read from their device through
`.cpu().numpy()`. `retrain_params` (single-pass retraining, -r) is not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..models.hmmset import CompiledHMMSet
from .fb import Accumulators


def _host(x) -> np.ndarray:
    """An accumulator field (a tensor on any device) as float64 numpy."""
    return x.cpu().numpy().astype(np.float64)

MINMIX = 1e-5
MINOCC = 1e-3  # minimum occupancy to touch a parameter


@dataclass
class UpdateFlags:
    """HERest -u flags: t(ransitions) m(eans) v(ariances) w(eights)."""

    means: bool = True
    variances: bool = True
    weights: bool = True
    transitions: bool = True

    @classmethod
    def parse(cls, s: str) -> "UpdateFlags":
        s = s.lower()
        return cls(
            means="m" in s,
            variances="v" in s,
            weights="w" in s,
            transitions="t" in s,
        )


def reestimate(
    comp: CompiledHMMSet,
    accs: Accumulators,
    flags: UpdateFlags = UpdateFlags(),
    var_floor: Optional[np.ndarray] = None,
    min_var: float = 1e-6,
):
    """Produce updated (means, variances, weights, transps) arrays.

    Returns numpy arrays shaped like the CompiledHMMSet blocks; write them
    back with models.hmmset.write_back. Parameters whose occupancy is
    below MINOCC are left at their current values (HTK keeps old params
    and warns).
    """
    occ = _host(accs.occ)  # (M,)
    sum_x = _host(accs.sum_x)  # (M, D)
    sum_xx = _host(accs.sum_xx)
    wt_occ = _host(accs.wt_occ)  # (S, maxmix)
    tr = _host(accs.tr)

    updatable = occ > MINOCC
    denom = np.where(updatable, occ, 1.0)[:, None]

    new_means = comp.means.astype(np.float64).copy()
    if flags.means:
        m = sum_x / denom
        new_means = np.where(updatable[:, None], m, new_means)

    new_vars = comp.variances.astype(np.float64).copy()
    if flags.variances:
        # HTK computes variance about the *updated* mean when means are
        # also updated (single-pass: E[x^2] - mean^2), else about the old.
        ref_mean = new_means if flags.means else comp.means.astype(np.float64)
        v = sum_xx / denom - ref_mean**2
        v = np.where(updatable[:, None], v, new_vars)
        floor = np.maximum(
            var_floor.astype(np.float64) if var_floor is not None else 0.0, min_var
        )
        new_vars = np.maximum(v, floor)

    new_weights = None
    if flags.weights:
        # normalise weights within each stream's slot block (single-stream
        # sets have one block covering all slots)
        blocks = comp.slot_blocks or [(0, wt_occ.shape[1])]
        old_w = np.where(comp.state_mix >= 0, np.exp(comp.state_logw), 0.0)
        new_weights = old_w.copy()
        for (j0, j1) in blocks:
            blk = wt_occ[:, j0:j1]
            state_occ = blk.sum(axis=1, keepdims=True)
            w = blk / np.maximum(state_occ, 1e-30)
            w = np.where(w < MINMIX, 0.0, w)
            wsum = w.sum(axis=1, keepdims=True)
            w = np.where(wsum > 0, w / np.maximum(wsum, 1e-30), w)
            new_weights[:, j0:j1] = np.where(
                state_occ > MINOCC, w, old_w[:, j0:j1]
            )

    new_transps = None
    if flags.transitions:
        tn, nmax = comp.log_transp.shape[0], comp.nmax
        tr3 = tr.reshape(tn, nmax, nmax)
        row = tr3.sum(axis=2, keepdims=True)
        old = np.exp(np.maximum(comp.log_transp.astype(np.float64), -745.0))
        old = np.where(comp.log_transp <= -0.5e10, 0.0, old)
        new_transps = np.where(row > MINOCC, tr3 / np.maximum(row, 1e-30), old)
        # exit row (last row of each matrix) is always zero in HTK
        new_transps[:, -1, :] = 0.0
        # renormalise guard: rows must sum to 1 where nonzero
        rs = new_transps.sum(axis=2, keepdims=True)
        new_transps = np.where(rs > 0, new_transps / np.maximum(rs, 1e-30), 0.0)

    return (
        new_means.astype(np.float32),
        new_vars.astype(np.float32),
        None if new_weights is None else new_weights.astype(np.float32),
        None if new_transps is None else new_transps.astype(np.float32),
    )
