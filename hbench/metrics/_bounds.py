"""The least time each hand-written kernel could take on one H100: the
larger of its bytes over HBM bandwidth and its operations over the FP32
peak. Frozen copies of `chip_smoke.py`'s `bound`, `decode_bound`,
`fb_bound`, `maxplus_bound` and the segmax row of `xw_bounds` (bytes count
each input once and each output once), so that a change to the program
cannot move the yardstick. `fb_bound` takes the live-cell count of each
utterance's logA instead of logA itself.
"""

from __future__ import annotations

from typing import Sequence

HBM_BPS = 3.35e12  # H100 SXM data sheet: HBM3 bandwidth, bytes/s
FP32_OPS = 67e12  # H100 SXM data sheet: FP32 outside the tensor cores


def bound(nbytes: float, ops: float) -> float:
    """Milliseconds: the larger of bytes over bandwidth and operations
    over the FP32 peak."""
    return max(nbytes / HBM_BPS, ops / FP32_OPS) * 1e3


def decode_bound(B: int, T: int, Ns: int, Nn: int, K: int) -> float:
    """decode_scan: outp, band, the per-state and per-node vectors and
    trans in; the (B, T, Nn) records and (B, Ns) finals out. Per frame and
    utterance an add and a max for each band candidate and word end, four
    more for each state's combine, and an add and a max for each (i, j)
    of the cross-word step (none at t = 0)."""
    nbytes = 4 * (B * T * Ns + K * Ns + 4 * Ns + Nn * Nn + 2 * Nn
                  + 3 * B * T * Nn + 3 * B * Ns)
    ops = B * (T * (2 * K + 6) * Ns + (T - 1) * (2 * Nn * Nn + Nn))
    return bound(nbytes, ops)


def fb_bound(T: int, Q: int, live: Sequence[int], t_real: Sequence[int],
             xi: bool = True) -> float:
    """fb_scans on B = len(live) composites of Q states padded to T
    frames: outp, logA, a0, aE, t_real in; alphas, betas, logP and (where
    xi) xi out. Each live cell of logA (`live[b]` of utterance b) costs
    about five operations (add, max, subtract, exp, add) per step of each
    scan (T steps) and, where xi, of xi (t_real - 1 steps); each output of
    a reduction a log and an add."""
    B = len(live)
    steps = [2 * T + max(t - 1, 0) * int(xi) for t in t_real]
    ops = 5 * sum(s * n for s, n in zip(steps, live)) + 4 * B * T * Q
    nbytes = 4 * (3 * B * T * Q + (1 + int(xi)) * B * Q * Q + 2 * B * Q
                  + 2 * B)
    return bound(nbytes, ops)


def maxplus_bound(B: int, C: int) -> float:
    """maxplus / tropical: WE and trans in, values and arguments out; an
    add and a compare per (b, i, j)."""
    return bound(4 * (C * C + 3 * B * C), 2 * B * C * C)


def segmax_bound(B: int, C: int, N: int, R: int) -> float:
    """segmax on N padded slots (preds and scores) feeding R target rows:
    WE (B, C), the slots and the row tables in, a value and a slot a
    (batch row, target row) out; an add and a compare per (b, slot)."""
    return bound(4 * (2 * N + B * C + 2 * B * R + 2 * R + 1), 2 * B * N)
