"""The windowed explicit-bigram slot gather: the counterpart of
htk_tpu/ops/xw_pallas.py.

    cand[b, slot] = WE[b, win[tile] * 128 + lidx[slot]] + lp[slot]

over slots laid out as the reference lays them out (`xw_pallas.py:33-36`):
slots sorted by 128-wide predecessor window, in tiles of TILE_ROWS x 128
slots that each read one window. The reference exists because Mosaic
gathers only along 128 lanes; a Hopper thread gathers from any address,
so the wrapper turns (win, lidx) into flat predecessor rows and makes one
launch of ops/xw_gather.gather_add. The reference's grid padding
(BLOCK_TILES) is not carried into the kernel; WE is padded to whole
windows with LZERO, as the reference pads it, so a pad slot past the last
row reads LZERO. `kernel_available` (a Mosaic compile probe) has no
counterpart. As in the reference, the decoder does not call this.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.logmath import LZERO
from . import xw_gather

TILE_ROWS = 8  # rows of 128 slots per tile; every tile reads one window
LANES = 128


def window_tables(pred: np.ndarray, lp: np.ndarray):
    """The reference's layout for slots (pred, lp) (host numpy): win (NT,)
    int32, lidx (NT * 8, 128) int32, lp (NT * 8, 128) float32 with LZERO
    padding, and each slot's flat position in the (NT * 1024,) output.
    Slots are sorted by window, stably; each window's slots fill whole
    tiles."""
    pred = np.asarray(pred, np.int64)
    tile = TILE_ROWS * LANES
    wins = pred >> 7
    order = np.argsort(wins, kind="stable")
    uw, counts = np.unique(wins, return_counts=True)
    nt = -(-counts // tile)
    win = np.repeat(uw, nt).astype(np.int32)
    base = np.concatenate([[0], np.cumsum(nt * tile)[:-1]])
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    grp = np.repeat(np.arange(len(uw)), counts)
    pos = np.empty(len(pred), np.int64)
    pos[order] = base[grp] + np.arange(len(pred)) - first[grp]
    n_out = int(nt.sum()) * tile
    lidx = np.zeros(n_out, np.int32)
    lpt = np.full(n_out, LZERO, np.float32)
    lidx[pos] = pred & (LANES - 1)
    lpt[pos] = np.asarray(lp, np.float32)
    return (win, lidx.reshape(-1, LANES), lpt.reshape(-1, LANES), pos)


def window_gather(WE, win, lidx, lp) -> torch.Tensor:
    """cand (B, NT * 1024) = WE[b, win[tile] * 128 + lidx] + lp, for WE
    (B, C) float32, win (NT,) int32, lidx (NT * 8, 128) int32 and lp
    (NT * 8, 128) float32 (already LM-scaled), all on one device; one
    gather_add launch on the card."""
    B, C = WE.shape
    NT = win.shape[0]
    shape = (NT * TILE_ROWS, LANES)
    for name, x, dt in (("win", win, torch.int32), ("lidx", lidx, torch.int32),
                        ("lp", lp, torch.float32)):
        if x.dtype != dt:
            raise TypeError(f"window_gather: {name} must be {dt}, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"window_gather: {name} must be contiguous")
    if win.dim() != 1 or tuple(lidx.shape) != shape or \
            tuple(lp.shape) != shape:
        raise ValueError(f"window_gather: win (NT,), lidx and lp {shape} "
                         f"expected, got {tuple(win.shape)}, "
                         f"{tuple(lidx.shape)}, {tuple(lp.shape)}")
    Cp = -(-C // LANES) * LANES
    if Cp != C:
        WE = torch.nn.functional.pad(WE, (0, Cp - C), value=LZERO)
    pred = (lidx.reshape(NT, TILE_ROWS * LANES)
            + (win * LANES)[:, None]).reshape(-1)
    return xw_gather.gather_add(WE, pred, lp.reshape(-1))
