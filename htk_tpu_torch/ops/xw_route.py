"""The exact explicit-bigram leg over a per-target in-edge CSR: the
counterpart of htk_tpu/ops/xw_route.py, with its public names.

    exp_v[b, j] = max over bigrams (i -> j) of WE[b, i] + p_ij
    exp_src[b, j] = the i of the first such slot in stream order

The reference packs the slots into a Benes/Clos transit layout so that
every dynamic access is a 128-lane Mosaic gather (`iroute`, the `ROT`
rotation and `_unrotate`, pow2 output groups, two kernel variants). A
Hopper thread gathers from any address, so none of that is carried over:
`build_route` sorts the slot stream by target, keeping the stream order
within a target as the reference does (its `eorder`), and
`routed_explicit_leg` is one launch of ops/xw_gather.segmax over that CSR.
Values and first-slot ties therefore equal the reference's and the bucket
leg's wherever a target has a predecessor; a target with none gets
(2 * LZERO, -1), where the reference promises only a value at or below
LZERO / 2.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import xw_gather


@dataclass
class RoutePlan:
    """Static tables for the routed explicit leg (host numpy)."""
    preds: np.ndarray    # (N,) i32: source row per slot, target-major
    scores: np.ndarray   # (N,) f32: bigram log-prob per slot (unscaled)
    seg_off: np.ndarray  # (C + 1,) i32: target j's slots are
    #                      [seg_off[j], seg_off[j + 1])
    C: int


def build_route(src: np.ndarray, tgt: np.ndarray, p: np.ndarray,
                C: int) -> RoutePlan:
    """Compile the CSR for the slot set (src row, tgt row, logp)."""
    src = np.asarray(src, np.int64)
    tgt = np.asarray(tgt, np.int64)
    order = np.argsort(tgt, kind="stable")
    indeg = np.bincount(tgt, minlength=C)
    seg_off = np.concatenate([[0], np.cumsum(indeg)])
    return RoutePlan(preds=src[order].astype(np.int32),
                     scores=np.asarray(p, np.float32)[order],
                     seg_off=seg_off.astype(np.int32), C=int(C))


def device_tables(plan: RoutePlan, device) -> dict:
    """The plan on `device`, with the identity output map."""
    def t(a):
        return torch.as_tensor(a, device=device)

    return {"preds": t(plan.preds), "scores": t(plan.scores),
            "seg_off": t(plan.seg_off),
            "out_row": torch.arange(plan.C, dtype=torch.int32,
                                    device=device),
            "C": plan.C}


def routed_explicit_leg(WE: torch.Tensor, dev: dict):
    """exp_v (B, C) float32 and exp_src (B, C) int32 in row order, for
    word-end scores WE (B, C). dev: `device_tables` output whose "scores"
    are already LM-scaled (as the reference's `t_p`). One segmax launch on
    the card."""
    return xw_gather.segmax(WE, dev["preds"], dev["scores"], dev["seg_off"],
                            dev["out_row"], dev["C"])
