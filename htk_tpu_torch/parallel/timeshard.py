"""Time-sharded forward-backward across the ranks of a mesh axis.

The PyTorch counterpart of `htk_tpu/parallel/timeshard.py`: for audio
longer than one device should hold, the (log, +)-semiring alpha/beta
recursions are associative, so one utterance's time axis is cut into D
blocks, one a rank. Write M_t[i, j] = logA[i, j] + outp_t[j]; then

  1. block operator: each rank folds its T/D frames into a (Q, Q)
     operator O_d = M_t0 (x) ... (x) M_t1 (block 0 replaces M_0 by the
     rank-1 injection a0 + outp_0); for a banded logA each step costs
     K Q^2 (column shifts, K the band width);
  2. prefix and suffix: the D operators are all-gathered, and each rank
     composes the exclusive prefix (the alpha entering its block) and
     suffix (beta at its block's last frame);
  3. local rescans: the ordinary frame scans, seeded by phase 2, give the
     block's (T/D, Q) alphas and betas.

Transition posteriors xi need the (outp + beta) row just past each block
boundary: the reference's `ppermute` of that row becomes an all-gather of
the ranks' first rows, of which rank d takes row (d + 1) mod D, so that the
module runs on all_reduce and all_gather alone (which NCCL and gloo both
take); logP is averaged over the ranks (`pmean`) and xi summed (`psum`).

Every rank passes the whole `outp` and takes its own block, as each JAX
process does; the functions return the rank's own alpha/beta blocks, and
logP and xi replicated on every rank; `gather_blocks` puts the blocks
back together. `jax.lax.scan`s are Python frame loops of torch ops, and
the reference's `vmap` over a local batch is a leading batch dimension.
The operator products associate differently from the vector scans, so
the results equal algo/fb's serial scans up to float32 re-association.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..tools._common import default_device
from ..utils.logmath import LZERO, exp_or_zero, ladd_reduce


def _band_of(logA: np.ndarray, lsmall=-0.5e10) -> int:
    """Upper bandwidth K of a forward-only transition matrix."""
    iu, ju = np.nonzero(np.asarray(logA) > lsmall)
    if len(ju) == 0:
        return 1
    return int(np.max(ju - iu)) + 1


def _op_step_banded(X: torch.Tensor, logA: torch.Tensor,
                    K: int) -> torch.Tensor:
    """(X (x) A)[.., j] = LSE_k X[.., k] + logA[k, j] for banded A.

    Only k in [j-K+1, j] contribute; offset d uses column-shifted X plus
    the d-th superdiagonal of logA.
    """
    Q = X.shape[-1]
    terms = []
    for d in range(K):
        band_d = torch.cat([logA.new_full((d,), LZERO),
                            torch.diagonal(logA, offset=d)])
        Xs = torch.cat([X.new_full(X.shape[:-1] + (d,), LZERO),
                        X[..., :Q - d]], dim=-1)
        terms.append(Xs + band_d)
    return ladd_reduce(torch.stack(terms, dim=0), dim=0)


def _op_compose(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Dense semiring product (X (x) Y)[.., i, j] = LSE_k X[.., i, k] +
    Y[.., k, j]."""
    return ladd_reduce(X[..., :, :, None] + Y[..., None, :, :], dim=-2)


def _identity_op(Q: int, dtype=torch.float32, device=None) -> torch.Tensor:
    eye = torch.full((Q, Q), LZERO, dtype=dtype, device=device)
    return eye.fill_diagonal_(0.0)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(D, *x.shape): every rank's x, in the group's rank order (gathered
    in the concatenated form, which gloo takes)."""
    D = dist.get_world_size(group)
    out = x.new_empty((D * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.view((D,) + tuple(x.shape))


def _all_sum(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


def _block_operator(outp_blk, logA, a0, K: int, t0: int) -> torch.Tensor:
    """Phase 1: the block's operator (Bl, Q, Q) over its frames, the first
    of which is global frame t0."""
    Bl, Tb, Q = outp_blk.shape
    X = _identity_op(Q, outp_blk.dtype, outp_blk.device).expand(Bl, Q, Q)
    for i in range(Tb):
        o = outp_blk[:, i]
        if t0 + i == 0:  # the rank-1 injection: every row a0 + outp_0
            X = (a0 + o)[:, None, :].expand(Bl, Q, Q)
        else:
            X = _op_step_banded(X, logA, K) + o[:, None, :]
    return X.contiguous()


def _boundaries(allO, d: int, aE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 2: from the D block operators (D, Bl, Q, Q), the alpha
    entering block d (the exclusive prefix's row 0: block 0's rank-1
    injection makes every row the same beyond it) and beta at the
    block's last frame (the exclusive suffix applied to aE; for the last
    block the suffix is the identity, and this is aE itself). A compose
    is computed only where the fold takes it."""
    D, Bl, Q, _ = allO.shape
    ident = _identity_op(Q, allO.dtype, allO.device).expand(Bl, Q, Q)
    prefix = ident
    for k in range(d):  # O_0 (x) ... (x) O_{d-1}
        prefix = _op_compose(prefix, allO[k])
    suffix = ident
    for k in range(d + 1, D):  # O_{d+1} (x) ... (x) O_{D-1}
        suffix = _op_compose(suffix, allO[k])
    return prefix[:, 0], ladd_reduce(suffix + aE, dim=-1)


def _rescan(outp_blk, logA, a0, alpha_in, beta_last, t0: int):
    """Phase 3: the block's alphas and betas (Bl, Tb, Q), the forward
    scan from `alpha_in`, the backward one from `beta_last` at the
    block's last frame."""
    Tb = outp_blk.shape[1]
    alphas = torch.empty_like(outp_blk)
    alpha = alpha_in
    for i in range(Tb):
        o = outp_blk[:, i]
        if t0 + i == 0:
            alpha = a0 + o
        else:
            alpha = ladd_reduce(alpha[:, :, None] + logA, dim=1) + o
        alphas[:, i] = alpha
    betas = torch.empty_like(outp_blk)
    beta = beta_last
    betas[:, Tb - 1] = beta
    for i in range(Tb - 2, -1, -1):
        beta = ladd_reduce(logA + (outp_blk[:, i + 1] + beta)[:, None, :],
                           dim=2)
        betas[:, i] = beta
    return alphas, betas


def _make_block_fb(axis, T, Q, D, logA, a0, aE, K, mesh):
    """The per-rank FB block body, outp block (Bl, T/D, Q) -> block
    alphas and betas (Bl, T/D, Q), logP (Bl,) and xi (Bl, Q, Q), with
    collectives over the D ranks of `mesh`'s axis `axis`; shared by the
    1-D time-sharded form and the 2-D (dp x t) batched form."""
    group = mesh.get_group(axis)
    d = dist.get_rank(group)

    def shard_fn(outp_blk):
        Tb = outp_blk.shape[1]
        if Tb * D != T or outp_blk.shape[2] != Q:
            raise ValueError(f"block {tuple(outp_blk.shape)} is not a "
                             f"1/{D} of (T={T}, Q={Q})")
        t0 = d * Tb
        O_blk = _block_operator(outp_blk, logA, a0, K, t0)
        alpha_in, beta_last = _boundaries(_all_gather(O_blk, group), d, aE)
        alphas, betas = _rescan(outp_blk, logA, a0, alpha_in, beta_last, t0)

        # LSE_i alpha_t[i] + beta_t[i] is logP at every t; average the
        # ranks' (re-association-level different) copies
        logp = _all_sum(ladd_reduce(alphas[:, 0] + betas[:, 0], dim=-1),
                        group) / D
        tgt_local = outp_blk + betas
        nxt_first = _all_gather(tgt_local[:, 0], group)[(d + 1) % D]
        tgt = torch.cat([tgt_local[:, 1:], nxt_first[:, None]], dim=1)
        ts = t0 + torch.arange(Tb, device=outp_blk.device)
        valid = (ts < T - 1).to(outp_blk.dtype)[None, :, None, None]
        x = alphas[:, :, :, None] + logA
        x += tgt[:, :, None, :]
        x -= logp[:, None, None, None]
        xi = _all_sum((exp_or_zero(x) * valid).sum(dim=1), group)
        return alphas, betas, logp, xi

    return shard_fn


def _operands(outp, logA, a0, aE, K):
    """outp, logA, a0, aE as float32 tensors on outp's device (a numpy
    outp goes to the tools' device) and the band width K."""
    if K is None:
        K = _band_of(torch.as_tensor(logA).cpu().numpy())
    if not isinstance(outp, torch.Tensor):
        outp = torch.as_tensor(outp, device=default_device())
    dev = outp.device
    return [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (outp, logA, a0, aE)] + [K]


def fb_time_sharded(
    outp,  # (T, Q) per-frame per-state log b, whole on every rank
    logA,  # (Q, Q) forward-only (banded) transitions
    a0,  # (Q,) entry log-probs
    aE,  # (Q,) exit log-probs
    mesh,
    axis: str = "t",
    K: Optional[int] = None,
):
    """Time-sharded alpha/beta/logP/xi for one utterance of T frames.

    Returns this rank's (alphas (T/D, Q), betas (T/D, Q)) block and the
    replicated logP () and xi_sum (Q, Q). Semantics match algo/fb's
    forward_scan + backward_scan + xi_scan with t_real = T."""
    group = mesh.get_group(axis)
    D, d = dist.get_world_size(group), dist.get_rank(group)
    outp, logA, a0, aE, K = _operands(outp, logA, a0, aE, K)
    T, Q = outp.shape
    if T % D:
        raise ValueError(f"T={T} not divisible by mesh axis {axis}={D}")
    Tb = T // D
    body = _make_block_fb(axis, T, Q, D, logA, a0, aE, K, mesh)
    alphas, betas, logp, xi = body(outp[None, d * Tb:(d + 1) * Tb])
    return alphas[0], betas[0], logp[0], xi[0]


def fb_time_sharded_batch(
    outp,  # (B, T, Q); B = Ddp * B_loc, T = Dt * T_blk
    logA,
    a0,
    aE,
    mesh,
    dp_axis: str = "d",
    t_axis: str = "t",
    K: Optional[int] = None,
):
    """2-D mesh forward-backward: a batch of equal-length utterances
    data-parallel over `dp_axis` while every utterance's time axis is
    sharded over `t_axis`.

    Returns this rank's (alphas (B/Ddp, T/Dt, Q), betas) block and logP
    (B,) and xi_sum (B, Q, Q), replicated on every rank."""
    dp_group, t_group = mesh.get_group(dp_axis), mesh.get_group(t_axis)
    Ddp, Dt = dist.get_world_size(dp_group), dist.get_world_size(t_group)
    i, d = dist.get_rank(dp_group), dist.get_rank(t_group)
    outp, logA, a0, aE, K = _operands(outp, logA, a0, aE, K)
    B, T, Q = outp.shape
    if B % Ddp:
        raise ValueError(f"B={B} not divisible by mesh axis "
                         f"{dp_axis}={Ddp}")
    if T % Dt:
        raise ValueError(f"T={T} not divisible by mesh axis {t_axis}={Dt}")
    Bl, Tb = B // Ddp, T // Dt
    body = _make_block_fb(t_axis, T, Q, Dt, logA, a0, aE, K, mesh)
    alphas, betas, logp, xi = body(
        outp[i * Bl:(i + 1) * Bl, d * Tb:(d + 1) * Tb])
    return (alphas, betas, _all_gather(logp, dp_group).reshape(B),
            _all_gather(xi, dp_group).reshape(B, Q, Q))


def gather_blocks(blk: torch.Tensor, mesh, t_axis: str = "t",
                  dp_axis: Optional[str] = None) -> torch.Tensor:
    """The whole (T, Q) (or, with `dp_axis`, (B, T, Q)) array from every
    rank's alpha or beta block."""
    if dp_axis is None:
        return _all_gather(blk, mesh.get_group(t_axis)).flatten(0, 1)
    parts = _all_gather(blk, mesh.get_group(t_axis))  # (Dt, Bl, Tb, Q)
    whole_t = parts.transpose(0, 1).flatten(1, 2)  # (Bl, T, Q)
    return _all_gather(whole_t, mesh.get_group(dp_axis)).flatten(0, 1)
