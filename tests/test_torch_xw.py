"""The factored cross-word leg's gather functions (htk_tpu_torch: ops/
xw_gather, ops/xw_route, ops/xw_window) against htk_tpu's, on the CPU.

The same numpy-seeded inputs go through both packages:

  - `xw_route.routed_explicit_leg` against htk_tpu's in Pallas interpret
    mode on tests/test_xw_route.py's random bigram graphs and on a
    tie-heavy integer-score graph: values and first-slot arguments exactly
    equal on targets with a predecessor, at or below LZERO/2 elsewhere
    (the reference promises no more there);
  - the decoder's flattened bucket leg (`algo.decode._xw_dev` +
    `xw_gather.segmax`) against the reference's per-bucket loop
    (htk_tpu/algo/decode.py:626-642, run here in jnp) on compile_lv_loop's
    factored tables, pads and dead rows included: exactly equal;
  - `xw_window.window_gather` against htk_tpu's in interpret mode on
    tests/test_pallas_decode.py's window tables and on `window_tables`'
    layout: exactly equal;
  - `bucket_max` and `lane_gather` against the probe kernels' formulas in
    numpy, gather-add and lane_gather also at N % 4 != 0 and on views at an
    odd element offset. The probes (benchmarks/gather_probe.py,
    dyngather_probe.py) pin pltpu.VMEM and take no interpret flag, so they
    cannot run here;
  - the plain segmax against a slot-by-slot loop, and the dispatchers: the
    CPU takes the plain version and counts no launch; wrong dtypes, shapes,
    places and non-contiguous operands are refused, each entry checking
    each operand once; segmax's `skip` flag is checked and, in the plain
    version, ignored.

The kernels themselves are held against these plain versions on the card
(tests/test_torch_kernels.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from htk_tpu.ops import xw_pallas as j_window
from htk_tpu.ops import xw_route as j_route
from htk_tpu_torch.algo import decode as pdec
from htk_tpu_torch.ops import xw_gather as xg
from htk_tpu_torch.ops import xw_route, xw_window
from htk_tpu_torch.synth import random_xw_operands
from htk_tpu_torch.utils.logmath import LZERO

from _torch_compare import one_torch_thread  # noqa: F401
from test_torch_lvdecode import BIG, TIED, nets
from test_xw_route import rand_graph


def t(a):
    return torch.as_tensor(np.asarray(a))


def loop_segmax(WE, preds, scores, seg_off, out_row, C_out):
    """Slot by slot in float32: first slot seeds, strict > updates."""
    B = WE.shape[0]
    v = np.full((B, C_out), np.float32(2 * LZERO), np.float32)
    a = np.full((B, C_out), -1, np.int32)
    for r, j in enumerate(out_row):
        for k in range(seg_off[r], seg_off[r + 1]):
            c = WE[:, preds[k]] + scores[k]
            upd = (c > v[:, j]) | (k == seg_off[r])
            v[upd, j] = c[upd]
            a[upd, j] = preds[k]
    return v, a


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, False)])
def test_segmax_plain_equals_slot_loop(seed, ties):
    ops = random_xw_operands(seed, B=3, C=120, n_slots=6000, ties=ties,
                             dead_rows=1)
    width = np.diff(ops[3])
    assert {0, 1} <= set(width.tolist()) and width.max() >= 500
    got = xg.segmax(*map(t, ops), 120)
    ref = loop_segmax(*ops, 120)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)


@pytest.mark.parametrize("C,N,B,ties", [(40, 200, 2, False),
                                        (300, 3000, 3, False),
                                        (300, 3000, 3, True)])
def test_routed_leg_equals_reference(C, N, B, ties):
    import jax.numpy as jnp

    rng = np.random.default_rng(C + N)
    src, tgt, p = rand_graph(rng, C, N)
    WE = rng.normal(size=(B, C)).astype(np.float32) * 10.0
    if ties:  # integer scores: equal candidates everywhere
        p = -rng.integers(0, 3, len(src)).astype(np.float64)
        WE = -rng.integers(0, 3, (B, C)).astype(np.float32)
    scale = np.float32(3.0)
    jd = j_route.device_tables(j_route.build_route(src, tgt, p, C))
    jd = {**jd, "t_p": jd["t_p"] * scale}
    rv, ra = [np.asarray(x) for x in j_route.routed_explicit_leg(
        jnp.asarray(WE), jd, interpret=True)]
    plan = xw_route.build_route(src, tgt, p, C)
    pd = xw_route.device_tables(plan, "cpu")
    pd = {**pd, "scores": pd["scores"] * scale}
    gv, ga = xw_route.routed_explicit_leg(t(WE), pd)
    has = np.bincount(tgt, minlength=C)[None].repeat(B, 0) > 0
    np.testing.assert_array_equal(gv.numpy()[has], rv[has])
    np.testing.assert_array_equal(ga.numpy()[has], ra[has])
    assert np.all(gv.numpy()[~has] == 2 * LZERO) and np.all(
        rv[~has] <= LZERO / 2)
    assert np.all(ga.numpy()[~has] == -1)


def ref_bucket_leg(WE, x, scale):
    """htk_tpu/algo/decode.py:626-642 on the net's buckets, in jnp."""
    import jax.numpy as jnp

    parts_v, parts_a = [], []
    for preds, scores in x["buckets"]:
        preds = jnp.asarray(preds)
        cand = WE[:, preds] + jnp.asarray(scores * np.float32(scale))[None]
        parts_v.append(jnp.max(cand, axis=2))
        k = jnp.argmax(cand, axis=2)
        parts_a.append(preds[jnp.arange(preds.shape[0])[None], k])
    inv = jnp.asarray(x["inv"])
    return (np.asarray(jnp.concatenate(parts_v, axis=1)[:, inv]),
            np.asarray(jnp.concatenate(parts_a, axis=1)[:, inv]))


@pytest.mark.parametrize("lex,integer", [(BIG, False), (TIED, True)])
def test_flattened_bucket_leg_equals_reference(lex, integer):
    """Pads (pred 0, score LZERO) stay in the segments: targets with no
    live predecessor keep the reference's pad value and argument."""
    import jax.numpy as jnp

    _jc, _jn, _pc, pn = nets(lex, factored=True)
    C = pn.n_nodes
    rng = np.random.default_rng(5)
    WE = rng.normal(size=(4, C)).astype(np.float32) * 5 - 20
    if integer:
        WE = -rng.integers(0, 3, (4, C)).astype(np.float32)
    WE[:, rng.random(C) < 0.3] = 2 * LZERO  # dead rows
    WE[3] = 2 * LZERO
    x = pdec._scale_xw(pdec._xw_dev(pn.xw_backoff, "cpu"), 2.0)
    gv, ga = pdec._segmax_leg(t(WE), x, C)
    rv, ra = ref_bucket_leg(jnp.asarray(WE), pn.xw_backoff, 2.0)
    np.testing.assert_array_equal(gv.numpy(), rv)
    np.testing.assert_array_equal(ga.numpy(), ra)
    assert int(x["seg_off"][-1]) == sum(p.size for p, _ in
                                        pn.xw_backoff["buckets"])


def pallas_window_tables(pred, lp):
    """tests/test_pallas_decode.py:85-100's layout (windows 0-2)."""
    order = np.argsort(pred >> 7, kind="stable")
    rows_i, rows_p, wins, spans = [], [], [], []
    k0, tile = 0, 8 * 128
    for w in range(3):
        sel = order[(pred[order] >> 7) == w]
        nt = -(-len(sel) // tile)
        ai = np.zeros(nt * tile, np.int32)
        ap = np.full(nt * tile, -1e10, np.float32)
        ai[: len(sel)] = pred[sel] & 127
        ap[: len(sel)] = lp[sel]
        rows_i.append(ai)
        rows_p.append(ap)
        wins += [w] * nt
        spans.append((k0, sel))
        k0 += nt * tile
    return (np.asarray(wins, np.int32),
            np.concatenate(rows_i).reshape(-1, 128),
            np.concatenate(rows_p).reshape(-1, 128), spans)


def test_window_gather_equals_reference():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    C, n_slots = 300, 5000
    pred = rng.integers(0, C, n_slots)
    lp = rng.normal(size=n_slots).astype(np.float32)
    WE = rng.normal(size=(2, C)).astype(np.float32)
    win, lidx, lpt, spans = pallas_window_tables(pred, lp)
    ref = np.asarray(j_window.window_gather(
        jnp.asarray(WE), jnp.asarray(win), jnp.asarray(lidx),
        jnp.asarray(lpt), interpret=True))
    got = xw_window.window_gather(t(WE), t(win), t(lidx), t(lpt)).numpy()
    np.testing.assert_array_equal(got, ref)  # pads past row C-1 included
    # window_tables builds the same layout, and each slot lands at `pos`
    win2, lidx2, lp2, pos = xw_window.window_tables(pred, lp)
    for a, b in ((win2, win), (lidx2, lidx), (lp2, lpt)):
        np.testing.assert_array_equal(a, b)
    for k0, sel in spans:
        np.testing.assert_array_equal(pos[sel], k0 + np.arange(len(sel)))
    np.testing.assert_array_equal(got[:, pos], WE[:, pred] + lp[None])


def test_bucket_max_equals_probe_formula():
    """benchmarks/gather_probe.py's kernel: max_f we[preds] + scores."""
    rng = np.random.default_rng(0)
    C, CB, FB = 500, 64, 16
    preds = rng.integers(0, C, (CB, FB)).astype(np.int32)
    scores = rng.standard_normal((CB, FB)).astype(np.float32)
    we = rng.standard_normal(C).astype(np.float32)
    got = xg.bucket_max(t(we), t(preds), t(scores))
    assert got.shape == (CB,)
    np.testing.assert_array_equal(got.numpy(),
                                  np.max(we[preds] + scores, axis=1))


def test_lane_gather_equals_probe_formula():
    """benchmarks/dyngather_probe.py's kernel: take_along_axis of the
    broadcast first table row, i.e. tbl[0][idx], exactly."""
    rng = np.random.default_rng(0)
    for width in (128, 2048):
        tbl = rng.standard_normal((8, width)).astype(np.float32)
        idx = rng.integers(0, width, (64, 128)).astype(np.int32)
        got = xg.lane_gather(t(tbl), t(idx)).numpy()
        tb = np.broadcast_to(tbl[0][None], (64, width))
        np.testing.assert_array_equal(
            got, np.take_along_axis(tb, idx, axis=1))


@pytest.mark.parametrize("tail", [1, 2, 3])
def test_gather_add_and_lane_gather_odd_sizes_and_views(tail):
    """N % 4 != 0 and operands at an odd element offset (the kernel's
    scalar edges), against the probe formulas."""
    rng = np.random.default_rng(tail)
    C, N = 200, 4 * 33 + tail
    WE = rng.normal(size=(3, C)).astype(np.float32)
    pred = rng.integers(0, C, N).astype(np.int32)
    lp = rng.normal(size=N).astype(np.float32)

    def odd(a):
        buf = torch.empty(a.size + 1, dtype=t(a).dtype)
        buf[1:] = t(a).reshape(-1)
        return buf[1:].view(a.shape)

    for view in (t, odd):
        got = xg.gather_add(view(WE), view(pred), view(lp)).numpy()
        np.testing.assert_array_equal(got, WE[:, pred] + lp[None])
        got = xg.gather_add_plain(view(WE), view(pred), None).numpy()
        np.testing.assert_array_equal(got, WE[:, pred])
        idx = pred.reshape(1, N)
        got = xg.lane_gather(view(WE), view(idx)).numpy()
        np.testing.assert_array_equal(
            got, np.take_along_axis(np.broadcast_to(WE[0][None], (1, C)),
                                    idx, axis=1))


def test_each_entry_checks_each_operand_once(monkeypatch):
    calls = []
    real = xg._check
    monkeypatch.setattr(xg, "_check",
                        lambda x, fn, name, *a: (calls.append((fn, name)),
                                                 real(x, fn, name, *a)))
    ops = [t(a) for a in random_xw_operands(0, B=2, C=40, n_slots=400)]
    for call, want in (
            (lambda: xg.segmax(*ops, 40),
             ["WE", "preds", "scores", "seg_off", "out_row"]),
            (lambda: xg.gather_add(*ops[:3]), ["WE", "pred", "lp"]),
            (lambda: xg.gather_add(ops[0], ops[1], None), ["WE", "pred"]),
            (lambda: xg.lane_gather(ops[0], ops[1][:40].reshape(4, 10)),
             ["tbl", "idx"])):
        calls.clear()
        call()
        assert [n for _f, n in calls] == want


def test_kernel_binding_declares_every_entry_point_argument():
    """The ctypes declarations match csrc/xw_gather.cu's C entry points:
    one argtype per parameter, pointers as c_void_p, ints as c_int."""
    import ctypes
    import re
    import types
    with open(xg.KERNEL.source) as f:
        src = f.read()
    lib = types.SimpleNamespace(segmax_launch=types.SimpleNamespace(),
                                gather_add_launch=types.SimpleNamespace())
    xg._bind(lib)
    for name in ("segmax_launch", "gather_add_launch"):
        params = re.search(r'extern "C" int %s\(([^)]*)\)' % name,
                           src).group(1).split(",")
        want = [ctypes.c_void_p if "*" in p else ctypes.c_int
                for p in params]
        assert getattr(lib, name).argtypes == want
        assert getattr(lib, name).restype is ctypes.c_int


def test_checks_refuse_dtype_rank_contiguity_and_place():
    """Each entry refuses, with one check per operand: a wrong dtype,
    rank or layout; and the kernel entries refuse operands off the card
    (the card-side mismatch is in tests/test_torch_kernels.py)."""
    WE, pred, lp = [t(a) for a in random_xw_operands(
        0, B=2, C=40, n_slots=400)[:3]]
    idx = pred[:40].reshape(4, 10)
    for fn, args, exc in (
            (xg.gather_add, (WE.double(), pred, lp), TypeError),
            (xg.gather_add, (WE, pred[None], lp), ValueError),
            (xg.gather_add, (WE, pred, lp[None]), ValueError),
            (xg.gather_add, (WE.t().contiguous().t(), pred, lp), ValueError),
            (xg.gather_add, (WE, pred.to("meta"), lp), ValueError),
            (xg.lane_gather, (WE, idx.long()), TypeError),
            (xg.lane_gather, (WE[0], idx), ValueError),
            (xg.lane_gather, (WE, idx.t()), ValueError),
            (xg.lane_gather, (WE.to("meta"), idx), ValueError),
            (xg.lane_gather, (WE[:0], idx), ValueError),
            (xg.lane_gather_cuda, (WE, idx), ValueError),
            (xg.gather_add_cuda, (WE, pred, None), ValueError)):
        with pytest.raises(exc):
            fn(*args)


def test_dispatch_cpu_takes_plain_and_counts_no_launch():
    ops = [t(a) for a in random_xw_operands(0, B=2, C=40, n_slots=400)]
    before = (xg.SEGMAX.launches, xg.GATHER_ADD.launches)
    for g, r in zip(xg.segmax(*ops, 40), xg.segmax_plain(*ops, 40)):
        assert torch.equal(g, r)
    assert torch.equal(xg.gather_add(ops[0], ops[1], ops[2]),
                       xg.gather_add_plain(ops[0], ops[1], ops[2]))
    xg.bucket_max(ops[0][0], ops[1][:40].reshape(10, 4),
                  ops[2][:40].reshape(10, 4))
    xg.lane_gather(ops[0], ops[1][:40].reshape(4, 10))
    assert (xg.SEGMAX.launches, xg.GATHER_ADD.launches) == before


def test_operand_checks_raise():
    WE, preds, scores, seg_off, out_row = [
        t(a) for a in random_xw_operands(0, B=2, C=40, n_slots=400)]
    ok = [WE, preds, scores, seg_off, out_row]
    for k, bad, exc in ((0, WE.double(), TypeError),
                        (1, preds.long(), TypeError),
                        (2, scores[:-1], ValueError),
                        (3, seg_off[:-1], ValueError),
                        (0, WE.t().contiguous().t(), ValueError),
                        (0, WE[0], ValueError)):
        args = list(ok)
        args[k] = bad
        with pytest.raises(exc):
            xg.segmax(*args, 40)
    with pytest.raises(ValueError):
        xg.segmax(*ok, 39)  # 40 segments do not fit 39 columns
    with pytest.raises(ValueError):
        xg.segmax(*[a.to("meta") for a in ok], 40)
    with pytest.raises(ValueError):
        xg.segmax_cuda(*ok, 40)
    with pytest.raises(ValueError):
        xg.gather_add_cuda(WE, preds, scores)
    with pytest.raises(TypeError):
        xg.gather_add(WE, preds.long(), scores)
    with pytest.raises(ValueError):
        xg.gather_add(WE, preds, scores[:-1])
    with pytest.raises(ValueError):
        xg.bucket_max(WE[0], preds[:40].reshape(4, 10).t(),
                      scores[:40].reshape(4, 10).t())
    with pytest.raises(ValueError):
        xw_window.window_gather(WE, torch.zeros(1, dtype=torch.int32),
                                torch.zeros((4, 128), dtype=torch.int32),
                                torch.zeros((4, 128)))


# the 20k-word net's bucket leg: segments per width (chip_smoke phase 12's
# net, lv_system(20000, seed=11) and compile_lv_loop)
BUCKET_WIDTHS = {8: 41, 12: 729, 16: 3715, 20: 6772, 24: 5552, 28: 2494,
                 32: 598, 36: 88, 40: 11}
# each class's edges: the widest segment of a class and the narrowest of
# the next (4 slots a lane)
EDGE_WIDTHS = [0, 1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33, 64, 65, 128, 129]


def widths_of(mix: str, rng) -> np.ndarray:
    """Segment widths in a random order: "random" as random_xw_operands
    draws them (0 or 1 for a tenth each, 4-64, two of 500-700), "bucket"
    the 20k net's bucket widths at a hundredth of the counts (at least one
    each), "edges" both sides of every class boundary, "empty" only empty
    segments, "mixed" all of these together."""
    if mix == "random":
        kind = rng.random(60)
        w = np.where(kind < 0.1, 0, np.where(kind < 0.2, 1,
                                             rng.integers(4, 65, 60)))
        w = np.concatenate([w, rng.integers(500, 701, 2)])
    elif mix == "bucket":
        w = np.concatenate([np.full(max(1, n // 100), k)
                            for k, n in BUCKET_WIDTHS.items()])
    elif mix == "edges":
        w = np.asarray(EDGE_WIDTHS * 2)
    elif mix == "empty":
        w = np.zeros(7, np.int64)
    else:
        w = np.concatenate([widths_of(m, rng)
                            for m in ("random", "bucket", "edges")])
    return rng.permutation(w)


def offsets(width) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(width)]).astype(np.int32)


@pytest.mark.parametrize("lanes", [None, 1, 2, 8, 32])
@pytest.mark.parametrize("mix", ["random", "bucket", "edges", "empty",
                                 "mixed"])
def test_schedule_covers_every_segment_once(mix, lanes):
    """Walking the schedule as the kernel does (a warp task's class from
    the prefix counts, its segments from the class's run of `order`)
    reaches every segment exactly once, with its slot range; each class's
    tasks are the fewest that hold its segments; each segment has the
    fewest lanes (a power of two, at least 2, at most 32) that leave a lane
    at most three of its quads (4 slots from a multiple of 4), or the
    forced count."""
    rng = np.random.default_rng(len(mix) + (lanes or 0))
    width = widths_of(mix, rng)
    sched = xg.schedule(offsets(width), lanes)
    K, R = xg.CLASSES, len(width)
    warp_pre, seg_pre = sched[:K + 1], sched[K + 1:2 * K + 2]
    span = sched[2 * K + 2:2 * K + 2 + 2 * R].reshape(R, 2)
    order = sched[2 * K + 2 + 2 * R:]
    assert len(order) == R
    assert warp_pre[0] == seg_pre[0] == 0 and seg_pre[-1] == R
    off = offsets(width)
    np.testing.assert_array_equal(span, np.stack([off[order],
                                                  off[order + 1]], 1))
    seen = []
    for t in range(int(warp_pre[-1])):
        c = int((warp_pre[1:K] <= t).sum())
        G = 1 << c
        for lane in range(0, 32, G):
            pos = seg_pre[c] + (t - warp_pre[c]) * (32 >> c) + lane // G
            if pos < seg_pre[c + 1]:
                seen.append((int(order[pos]), G))
    assert sorted(s for s, _G in seen) == list(range(len(width)))
    for c in range(K):
        n = seg_pre[c + 1] - seg_pre[c]
        assert warp_pre[c + 1] - warp_pre[c] == -(-n // (32 >> c))
    nq = (off[1:] + 3) // 4 - off[:-1] // 4
    for s, G in seen:
        if lanes is None:
            assert G == 32 or nq[s] <= 3 * G or width[s] == 0
            assert G == 2 or nq[s] > 3 * (G // 2)
            assert G >= 2
        else:
            assert G == lanes
    np.testing.assert_array_equal(xg.quads(off), np.where(width > 0, nq, 0))
    with pytest.raises(ValueError):
        xg.schedule(offsets(width), 3)


@pytest.mark.parametrize("B,C,sms,staged,want", [
    (8, 20000, 132, None, (2, 33, True)),    # the 20k frame: 4 row groups
    (1, 22000, 132, None, (1, 132, True)),   # bucket_max's probe shape
    (17, 700, 132, None, (8, 4, True)),      # few tasks: few blocks
    (3, 700, 132, None, (4, 132, True)),     # rows a power of two
    (3, 20000, 132, None, (2, 66, True)),
    (8, 100000, 132, None, (8, 157, False)),  # a row does not fit
    (8, 20000, 132, False, (8, 157, False)),
    (3, 58112, 132, True, (1, 44, True)),    # exactly one row fits
])
def test_launch_shape(B, C, sms, staged, want):
    """Rows a block: staged, a power of two that fits in 227 KB, at most 8
    and no more than B asks; unstaged, up to 8, B shared evenly among the
    row groups. One block an SM when staged, two unstaged, no more than
    the warp tasks need (32 a block)."""
    assert xg.launch_shape(B, C, 100 if (B, C) == (17, 700) else 5000, sms,
                           staged) == want
    rows, chunks, st = want
    if st:
        assert 4 * rows * C <= xg.SMEM_MAX and rows & (rows - 1) == 0
    with pytest.raises(ValueError):
        xg.launch_shape(B, 58113, 5000, sms, True)


INT_MAX = np.iinfo(np.int32).max


def emulate_segmax(WE, preds, scores, seg_off, out_row, C_out, lanes):
    """The kernel's split and merge in torch ops: per class of the
    schedule, lane j of a segment's G walks quads q0 + j, q0 + j + G, ...
    (q0 = k0 // 4, k0 and k1 from the schedule's spans), the slots of a
    quad in order and only those in [k0, k1), keeping the (value, slot,
    pred) that beats its own (a larger value, or
    an equal one at an earlier slot), empty lanes holding (-inf, INT_MAX);
    then log2 G xor-shuffle steps merge the lanes by the same rule, after
    which every lane of a group holds the same triple."""
    sched = xg.schedule(seg_off.numpy(), lanes)
    K, R = xg.CLASSES, len(seg_off) - 1
    seg_pre, order = sched[K + 1:2 * K + 2], sched[2 * K + 2 + 2 * R:]
    B = WE.shape[0]
    val = torch.full((B, C_out), 2 * LZERO)
    arg = torch.full((B, C_out), -1, dtype=torch.int32)
    for c in range(K):
        segs = torch.as_tensor(order[seg_pre[c]:seg_pre[c + 1]]).long()
        if not len(segs):
            continue
        G = 1 << c
        span = torch.as_tensor(sched[2 * K + 2:2 * K + 2 + 2 * R]).reshape(
            R, 2)[seg_pre[c]:seg_pre[c + 1]].long()
        k0, k1 = span[:, 0], span[:, 1]
        L = max(1, -(-int(((k1 + 3) // 4 - k0 // 4).max()) // G))
        qd = (k0[:, None, None] // 4 + torch.arange(G)[None, :, None]
              + G * torch.arange(L)[None, None, :])  # (n, G, L) quads
        k = (4 * qd[..., None] + torch.arange(4)).reshape(len(segs), G,
                                                          4 * L)
        live = (k >= k0[:, None, None]) & (k < k1[:, None, None])
        kc = torch.where(live, k, 0)
        p = preds[kc].long()
        cand = torch.where(live, WE[:, p] + scores[kc], -torch.inf)
        kk = torch.where(live, k, INT_MAX).expand(B, -1, -1, -1)
        pp = p.expand(B, -1, -1, -1)
        bv = torch.full(cand.shape[:3], -torch.inf)
        bk = torch.full(cand.shape[:3], INT_MAX, dtype=torch.int64)
        bp = torch.full(cand.shape[:3], -1, dtype=torch.int64)

        def take(v, kx, px):
            win = (v > bv) | ((v == bv) & (kx < bk))
            return (torch.where(win, v, bv), torch.where(win, kx, bk),
                    torch.where(win, px, bp))

        for i in range(4 * L):
            bv, bk, bp = take(cand[..., i], kk[..., i], pp[..., i])
        step = G >> 1
        while step:
            perm = torch.arange(G) ^ step
            bv, bk, bp = take(bv[..., perm], bk[..., perm], bp[..., perm])
            step >>= 1
        for x in (bv, bk, bp):
            assert bool((x == x[..., :1]).all())  # every lane agrees
        none = bk[..., 0] == INT_MAX
        cols = out_row[segs].long()
        val[:, cols] = torch.where(none, 2 * LZERO, bv[..., 0])
        arg[:, cols] = torch.where(none, -1, bp[..., 0]).to(torch.int32)
    return val, arg


def tie_heavy_operands(seed: int, B: int, C: int = 300):
    """segmax operands over the "mixed" widths: integer scores from
    {0, -1, -2} (ties everywhere), a tenth of the slots pads (LZERO), WE
    from {0, -1, -2} with 2 LZERO at a fifth of its cells and -inf at a
    twentieth and in its last column, which every other one-slot segment
    names; the last row dead (2 LZERO) and, for B > 8, another all -inf;
    out_row a permutation into R + 5 columns."""
    rng = np.random.default_rng(seed)
    seg_off = offsets(widths_of("mixed", rng))
    R, N = len(seg_off) - 1, int(seg_off[-1])
    preds = rng.integers(0, C, N).astype(np.int32)
    scores = np.where(rng.random(N) < 0.1, LZERO,
                      -rng.integers(0, 3, N)).astype(np.float32)
    WE = -rng.integers(0, 3, (B, C)).astype(np.float32)
    cell = rng.random((B, C))
    WE[cell < 0.2] = 2 * LZERO
    WE[cell > 0.95] = -np.inf
    WE[:, -1] = -np.inf
    preds[seg_off[:-1][np.diff(seg_off) == 1][::2]] = C - 1
    if B > 1:
        WE[-1] = 2 * LZERO
    if B > 8:
        WE[-2] = -np.inf
    out_row = rng.permutation(R + 5)[:R].astype(np.int32)
    return [t(a) for a in (WE, preds, scores, seg_off, out_row)], R + 5


@pytest.mark.parametrize("B", [1, 8, 17])
@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 32, None])
def test_kernel_split_and_merge_equal_plain(lanes, B):
    """The kernel's partition of each segment over G lanes and its
    (value, then earliest slot) merge give segmax_plain's values and
    first-slot arguments exactly, at every forced G and the schedule's
    own, on tie-heavy scores with pads, dead rows and -inf cells."""
    ops, C_out = tie_heavy_operands(B * 7 + (lanes or 0), B)
    got = emulate_segmax(*ops, C_out, lanes)
    ref = xg.segmax_plain(*ops, C_out)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert bool((ref[0] == -torch.inf).any())  # all -inf segments reached


@pytest.mark.parametrize("flag", [False, True])
def test_plain_segmax_accepts_skip_and_ignores_it(flag):
    """The kernel leaves its outputs unspecified under a set flag; the
    plain version computes them all the same."""
    ops = [t(a) for a in random_xw_operands(1, B=3, C=40, n_slots=400,
                                            ties=True)]
    ref = xg.segmax_plain(*ops, 45)
    for fn in (xg.segmax, xg.segmax_plain):
        got = fn(*ops, 45, skip=torch.tensor(flag))
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    for bad, exc in ((torch.tensor([flag]), ValueError),
                     (torch.tensor(1), TypeError)):
        with pytest.raises(exc):
            xg.segmax(*ops, 45, skip=bad)
