"""Batched GMM log-likelihoods (HTK OutP) in torch.

The PyTorch counterpart of `htk_tpu/ops/outp.py`, with the same functions
and the same algebra:

  logN_m(x) = -0.5 * (x^2 . a_m  - 2 x . b_m  + c_m)
  a_m = 1/var_m,  b_m = mu_m/var_m,  c_m = gConst_m + sum_d mu_md^2/var_md

so all frames x all Gaussians is one (T, 2D) @ (2D, M) `torch.matmul`
(the JAX package leaves that product to XLA too; no kernel is owed).
State-level log b_j(x) then logsumexps mixture scores with their log
weights under HTK's LAdd clamps.

Precision: `HTKTPU: PRECISION = highest` (the default) is full fp32 with
TF32 off; `high` and `default` turn TF32 on for the matmul, as the JAX
package relaxes its MXU precision. Both TF32 switches are set explicitly
around every product, whatever the process-wide default.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.errors import HError
from ..utils.logmath import LZERO, ladd_reduce


@contextlib.contextmanager
def matmul_precision(precision: str):
    """Set TF32 for cuBLAS and cuDNN from an htk precision name, and
    restore the previous switches afterwards."""
    allow = precision != "highest"
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def pack_gaussians(means: torch.Tensor, variances: torch.Tensor,
                   gconsts: torch.Tensor):
    """Precompute the (2D, M) weight block and (M,) bias for mix_scores."""
    a = 1.0 / variances  # (M, D)
    b = means / variances
    c = gconsts + torch.sum(means * means / variances, dim=1)  # (M,)
    Wt = torch.cat([a, -2.0 * b], dim=1).T.contiguous()  # (2D, M)
    return Wt, c


def mix_scores(x: torch.Tensor, Wt: torch.Tensor, c: torch.Tensor,
               precision: str = "highest") -> torch.Tensor:
    """(..., T, D) frames -> (..., T, M) per-Gaussian log-likelihoods."""
    feats = torch.cat([x * x, x], dim=-1)  # (..., T, 2D)
    with matmul_precision(precision):
        quad = torch.matmul(feats, Wt)  # (..., T, M)
    return -0.5 * (quad + c)


def full_cov_mix_scores(x: torch.Tensor, fc_proj: torch.Tensor,
                        fc_mu: torch.Tensor, gconsts: torch.Tensor,
                        precision: str = "highest") -> torch.Tensor:
    """(..., T, D) frames -> (..., T, M) full-covariance log-likelihoods:
    ||x @ L_m - mu~_m||^2 over each Gaussian's precision Cholesky L_m."""
    with matmul_precision(precision):
        y = torch.einsum("...td,mde->...tme", x, fc_proj)
    q = torch.sum((y - fc_mu) ** 2, dim=-1)  # (..., T, M)
    return -0.5 * (gconsts + q)


def state_outp(mix_lp: torch.Tensor, state_mix: torch.Tensor,
               state_logw: torch.Tensor, slot_blocks=None,
               state_sw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., T, M) Gaussian log-probs -> (..., T, S) state log-likelihoods.

    Gathers each state's mixture rows and LAdd-reduces them with their
    log weights; padded slots (state_mix < 0) never contribute. Multi-
    stream sets sum per-stream blocks scaled by stream-weight exponents.
    """
    safe_idx = torch.clamp(state_mix, min=0)  # (S, n_slots)
    gathered = mix_lp[..., safe_idx]  # (..., T, S, n_slots)
    weighted = gathered + state_logw
    weighted = torch.where(state_mix >= 0, weighted,
                           torch.full_like(weighted, LZERO))
    if slot_blocks is None or len(slot_blocks) <= 1:
        out = ladd_reduce(weighted, dim=-1)  # (..., T, S)
        if state_sw is not None and len(slot_blocks or []) == 1:
            out = out * state_sw[:, 0]
        return out
    total = None
    for j0, j1 in slot_blocks:
        bs = ladd_reduce(weighted[..., j0:j1], dim=-1)
        bs = bs * state_sw[:, j0]  # stream-weight exponent
        total = bs if total is None else total + bs
    return total


def all_state_outp(
    x: torch.Tensor,
    means: torch.Tensor,
    variances: torch.Tensor,
    gconsts: torch.Tensor,
    state_mix: torch.Tensor,
    state_logw: torch.Tensor,
    precision: str = "highest",
    slot_blocks=None,
    state_sw: Optional[torch.Tensor] = None,
    fc_proj: Optional[torch.Tensor] = None,
    fc_mu: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frames (..., T, D) -> (state log-likes (..., T, S), Gaussian
    log-likes (..., T, M)). `fc_proj`/`fc_mu` select the full-covariance
    scorer."""
    if fc_proj is not None:
        mlp = full_cov_mix_scores(x, fc_proj, fc_mu, gconsts,
                                  precision=precision)
    else:
        Wt, c = pack_gaussians(means, variances, gconsts)
        mlp = mix_scores(x, Wt, c, precision=precision)
    return state_outp(mlp, state_mix, state_logw, slot_blocks, state_sw), mlp


class GaussianScorer(nn.Module):
    """A compiled HMM set's Gaussians, packed once onto a device.

    Buffers: the packed (2D, M) weight block `Wt` and bias `c` (diagonal
    sets) or `fc_proj`/`fc_mu`/`gconsts` (full-covariance sets), and the
    state tables `state_mix`/`state_logw` (+ `state_sw` for multi-stream
    sets). forward(x) maps frames (..., T, D) to state log-likelihoods
    (..., T, S), as `all_state_outp` does.

    `params` ({means, variances, gconsts}, numpy) replaces a diagonal
    set's Gaussians: the speaker-adaptation override of the decoders'
    `model_params` hook. The set's own arrays are read as they are when
    the scorer is built; a scorer does not follow later changes to them.
    """

    def __init__(self, comp, device, precision: str = "highest",
                 params: Optional[dict] = None):
        super().__init__()

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.precision = precision
        self.full_cov = bool(comp.full_cov)
        if self.full_cov:
            if params is not None:
                HError(7450, "GaussianScorer: parameter overrides need a "
                             "diagonal set")
            self.register_buffer("fc_proj", f32(comp.fc_proj))
            self.register_buffer("fc_mu", f32(comp.fc_mu))
            self.register_buffer("gconsts", f32(comp.gconsts))
        else:
            g = ((comp.means, comp.variances, comp.gconsts)
                 if params is None else (params["means"],
                                         params["variances"],
                                         params["gconsts"]))
            Wt, c = pack_gaussians(*(f32(a) for a in g))
            self.register_buffer("Wt", Wt)
            self.register_buffer("c", c)
        self.register_buffer("state_mix", torch.as_tensor(
            np.asarray(comp.state_mix, np.int64), device=device))
        self.register_buffer("state_logw", f32(comp.state_logw))
        self.slot_blocks = tuple(comp.slot_blocks) or None
        self.register_buffer(
            "state_sw",
            f32(comp.state_sw) if comp.state_sw is not None else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.full_cov:
            mlp = full_cov_mix_scores(x, self.fc_proj, self.fc_mu,
                                      self.gconsts, self.precision)
        else:
            mlp = mix_scores(x, self.Wt, self.c, self.precision)
        return state_outp(mlp, self.state_mix, self.state_logw,
                          self.slot_blocks, self.state_sw)
