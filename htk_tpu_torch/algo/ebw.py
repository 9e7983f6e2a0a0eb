"""Extended Baum-Welch updates for discriminative training (MMI/MPE).

Mirrors `HTKTools/HMMIRest.c`'s update step (SURVEY.md §3.5):

  mu'    = (num_x  - den_x  + D*mu )  / (num_occ - den_occ + D)
  sigma' = (num_xx - den_xx + D*(sigma^2 + mu^2)) / (num_occ - den_occ + D)
           - mu'^2

with per-Gaussian smoothing constant D = max(E * den_occ, D_min) where
D_min is doubled until every variance dimension stays positive (HTK's
halving/doubling search), E typically 2. I-smoothing (tau) interpolates
the numerator statistics toward their own mean with strength tau.

Weights use the EBW ratio update; transitions keep their ML values (as
standard HTK MMI recipes do).

Copied from `htk_tpu/algo/ebw.py`: host numpy in float64. The caller
brings the accumulators to the host first (tools/hmmirest.py); a CUDA
tensor here would fail in `np.asarray`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..models.hmmset import CompiledHMMSet
from .fb import Accumulators

MINMIX = 1e-5


@dataclass
class EBWConfig:
    e: float = 2.0  # E constant (config E)
    tau_i: float = 0.0  # I-smoothing tau (ISMOOTHTAU)
    min_var: float = 1e-6
    min_occ: float = 1e-3


def ebw_update(
    comp: CompiledHMMSet,
    num: Accumulators,
    den: Accumulators,
    cfg: EBWConfig = EBWConfig(),
    var_floor: Optional[np.ndarray] = None,
):
    """Returns (means, variances, weights) updated by EBW."""
    n_occ = np.asarray(num.occ, np.float64)
    n_x = np.asarray(num.sum_x, np.float64)
    n_xx = np.asarray(num.sum_xx, np.float64)
    d_occ = np.asarray(den.occ, np.float64)
    d_x = np.asarray(den.sum_x, np.float64)
    d_xx = np.asarray(den.sum_xx, np.float64)

    # I-smoothing: boost numerator stats toward their own distribution
    if cfg.tau_i > 0:
        scale = (n_occ + cfg.tau_i) / np.maximum(n_occ, 1e-10)
        n_x = n_x * scale[:, None]
        n_xx = n_xx * scale[:, None]
        n_occ = n_occ + cfg.tau_i

    mu0 = comp.means.astype(np.float64)
    var0 = comp.variances.astype(np.float64)
    M, Dd = mu0.shape

    new_mu = mu0.copy()
    new_var = var0.copy()
    floor = np.maximum(
        var_floor.astype(np.float64) if var_floor is not None else 0.0,
        cfg.min_var,
    )

    for m in range(M):
        if n_occ[m] + d_occ[m] < cfg.min_occ:
            continue
        D = max(cfg.e * d_occ[m], 1.0)
        for _ in range(40):
            denom = n_occ[m] - d_occ[m] + D
            if denom <= 0:
                D *= 2
                continue
            mu = (n_x[m] - d_x[m] + D * mu0[m]) / denom
            var = (
                n_xx[m] - d_xx[m] + D * (var0[m] + mu0[m] ** 2)
            ) / denom - mu**2
            if np.all(var > 0):
                break
            D *= 2
        else:
            continue  # keep old params if no valid D found
        new_mu[m] = mu
        new_var[m] = np.maximum(var, floor)

    # EBW weight update: w' ∝ w * (num_occ/den-adjusted ratio), HTK-style
    wt_n = np.asarray(num.wt_occ, np.float64)  # (S, maxmix)
    wt_d = np.asarray(den.wt_occ, np.float64)
    old_w = np.where(comp.state_mix >= 0, np.exp(comp.state_logw), 0.0)
    # constant C per state for positivity: C >= max over mixes of den/w
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(old_w > 0, wt_d / np.maximum(old_w, 1e-10), 0.0)
    C = np.max(ratio, axis=1, keepdims=True) * 2.0 + 1.0
    w_new = wt_n - wt_d + C * old_w
    w_new = np.maximum(w_new, 0.0)
    wsum = w_new.sum(axis=1, keepdims=True)
    w_new = np.where(wsum > 0, w_new / np.maximum(wsum, 1e-30), old_w)
    w_new = np.where(w_new < MINMIX, 0.0, w_new)
    wsum = w_new.sum(axis=1, keepdims=True)
    w_new = np.where(wsum > 0, w_new / np.maximum(wsum, 1e-30), old_w)
    # states with no numerator occupancy keep old weights
    state_occ = wt_n.sum(axis=1, keepdims=True)
    w_new = np.where(state_occ > cfg.min_occ, w_new, old_w)

    return (
        new_mu.astype(np.float32),
        new_var.astype(np.float32),
        w_new.astype(np.float32),
    )
