"""The frozen bounds reproduce the records' numbers, and the rate and
percentile arithmetic is right on made-up timings."""

import statistics

import numpy as np
import pytest

from hbench.core.stats import percentile, rate, spread
from hbench.metrics import _bounds
from hbench.metrics._read import idle, mfu, roofline
from hbench.core.trace import Trace


def test_decode_bound_matches_the_record():
    # PERF.md's kernel table: B = 8, T = 512, Ns = 11,955, Nn = 1,000, K = 2
    assert round(_bounds.decode_bound(8, 512, 11955, 1000, 2), 6) == 0.129399


def test_fb_bound_matches_the_phone_loop_record():
    # the phone loop (B = 1, T = 504, Q = 10,332) without xi; its live
    # cells as the record's operation count (5.99e10) gives them
    assert round(_bounds.fb_bound(504, 10332, [11878357], [504], xi=False),
                 6) == 0.893847


def test_maxplus_and_segmax_bounds_match_the_records():
    assert round(_bounds.maxplus_bound(8, 1000), 6) == 0.001223
    assert round(_bounds.segmax_bound(8, 20000, 429780, 19997), 6) == 0.001647


def test_rate_and_percentile_on_made_up_timings():
    ms = [30.0, 31.0, 29.0, 45.0, 33.0, 32.0, 30.5, 80.0, 31.5, 30.0]
    for q in (50, 90, 95, 99):
        assert percentile(ms, q) == pytest.approx(np.percentile(ms, q))
    assert percentile([5.0], 95) == 5.0
    assert rate(45.0 * 300, 9.7) == pytest.approx(1391.75257732)
    with pytest.raises(ValueError):
        rate(1.0, 0.0)


def test_spread_is_the_quartile_distance_over_the_median():
    v = [100.0, 101.0, 99.0, 102.0, 98.0, 100.5]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert spread(v) == pytest.approx((q3 - q1) / statistics.median(v))


def test_readers_on_a_made_up_trace():
    tr = Trace(window_s=2.0, busy_s=0.5,
               kernel_s={"void decode_scan_kernel<1>(...)": 0.09},
               kernel_n={"void decode_scan_kernel<1>(...)": 9})
    ctx = {"side": "decode", "window_s": 2.0, "model_flops": 67e12 * 0.02,
           "bounds_ms": {"decode_scan": 10 * 0.3}, "trace": tr,
           "launches": {"decode_scan": 10}}
    assert mfu(ctx, "decode") == pytest.approx(1.0)
    assert mfu(ctx, "train") is None
    assert idle(ctx, "decode") == pytest.approx(75.0)
    # 9 of 10 launches recorded: 0.1 s of device time for 3 ms of bound
    assert roofline(ctx, "decode_scan", "decode_scan_kernel") == \
        pytest.approx(3.0)
    assert roofline(ctx, "segmax", "segmax_kernel") is None
    assert roofline(dict(ctx, trace=None), "decode_scan",
                    "decode_scan_kernel") is None


class _Ev:
    def __init__(self, name, card, a, b, kind=None):
        self._v = (name, card, a, b)
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] else "DeviceType.CPU"

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]


class _Prof:
    def __init__(self, evs):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {"events":
                                                      lambda s: evs})()


@pytest.mark.parametrize("kinds", [False, True])
def test_trace_union_kernels_and_idle_gaps(kinds):
    """Busy time is the union of the card's activity inside the window;
    the card's copy of an annotation is not activity; a gap is named after
    the innermost host operation over its middle. With and without the
    profiler's activity kinds (torch builds differ)."""
    from hbench.core.trace import WINDOW, read

    def ev(name, card, a, b, kind):
        return _Ev(name, card, a, b, kind if kinds else None)

    evs = [ev(WINDOW, False, 0, 1000, "user_annotation"),
           ev(WINDOW, True, 0, 1000, "gpu_user_annotation"),
           ev("aten::copy_", False, 100, 400, "cpu_op"),
           ev("cudaLaunchKernel", False, 90, 95, "cuda_runtime"),
           ev("void decode_scan_kernel<2>", True, 50, 150, "kernel"),
           ev("void decode_scan_kernel<2>", True, 120, 200, "kernel"),
           ev("Memcpy DtoH", True, 600, 700, "gpu_memcpy"),
           ev("late", True, 950, 1100, "kernel")]
    tr = read(_Prof(evs))
    assert tr.window_s == pytest.approx(1e-6)
    assert tr.busy_s == pytest.approx((150 + 100 + 50) * 1e-9)
    s, n = tr.time_of("decode_scan_kernel")
    assert n == 2 and s == pytest.approx(180e-9)
    gaps = dict(tr.idle_gaps)
    assert gaps["aten::copy_"] == pytest.approx(400e-9)  # [200, 600]
    assert gaps["idle, no host operation"] == pytest.approx(300e-9)
    assert sum(gaps.values()) == pytest.approx(700e-9)


def test_segment_scores_are_one_word_paths():
    """A word's score inside its frames is the path score of the one-word
    path over them, less its entry and exit LM weights; a word read off a
    longer pass scores as if aligned alone."""
    import torch

    from hbench.reference import decoder as ref

    rng = np.random.default_rng(3)
    V, P, T = 5, 7, 40
    word_states = [rng.integers(0, P, rng.integers(3, 7)) for _ in range(V)]
    succ = [sorted(rng.choice(V, 2, replace=False).tolist())
            for _ in range(V)]
    lm = {"explicit": -0.7, "start": -1.6, "end": -0.7}
    loop = ref.WordLoop(word_states, succ, lm, (np.log(0.6), np.log(0.4)),
                        3.0, -2.0, torch.device("cpu"))
    ll = torch.as_tensor(rng.normal(-5.0, 2.0, (T, P)))
    for w in range(V):
        seg = ref.segment_scores(loop, ll, word_states, [w, w], [0, 0],
                                 [T - 1, 19])
        alone = ref.segment_scores(loop, ll[:20], word_states, [w], [0],
                                   [19])
        path = ref.path_scores(loop, [ll], [([w], [(0, T - 1)])],
                               word_states)
        assert seg[0] == pytest.approx(path[0] - 3.0 * (-1.6 - 0.7))
        assert seg[1] == pytest.approx(alone[0])
    assert loop.lm_pair(0, succ[0][0]) == -0.7
    assert loop.lm_pair(0, ({*range(V)} - {*succ[0]}).pop()) == -np.inf
