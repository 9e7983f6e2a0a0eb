"""What the two decoding drivers share: the system and the pool built from
the seed, the buckets, the closed-loop window, the sample of finished
requests and its comparison with the plain reference.

A bucket is a fixed group of utterances of similar length (the pool sorted
by length and cut into groups of the cell's `batch`). The window hands the
buckets over one at a time in a fixed interleaved order (the same sizes in
the same order for every seed), each as soon as the last one's results
are on the host, and stops handing over once `seconds` have passed; it
closes when the last bucket handed over is done, so every rate is taken
over whole buckets and the whole time.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from ..core.stats import rate
from ..reference import decoder as ref
from ..traffic.synth import (build_structure, lm_weights, make_gaussians,
                             make_pool, transitions)
from . import _system

PAD_T = 128  # the decoders pad a bucket's frames to a multiple of this
# a path the reference scores within this share of its best is a best
# path: two float64 sums of one path in different orders part by ~1e-15
NOT_BEST = 1e-9
F32_U = 2.0 ** -24  # float32's unit roundoff


def pad_T(lens) -> int:
    return -(-max(lens) // PAD_T) * PAD_T


def interleaved(n: int) -> List[int]:
    """0..n-1 in a fixed order that spreads neighbours apart (a stride near
    n / golden ratio, coprime to n)."""
    step = max(1, round(n / 1.618034))
    while math.gcd(step, n) != 1:
        step += 1
    return [(k * step) % n for k in range(n)]


class DecodingJob:
    """Set-up, window and check of one decoding cell (subclasses give the
    network and the call)."""

    side = "decode"
    extra = False  # whether the check reads a request's bulky output

    def __init__(self, cell, seed: int, device, control: bool = False):
        cfg, wl = cell.config, cell.workload
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        self.setup_phases: List[tuple] = []
        self.window_log: List[str] = []  # a line a window, for stderr
        t = time.perf_counter()
        self.precision = "default" if control else cfg["precision"]
        self.lm_scale, self.word_pen = float(wl["lm_scale"]), float(
            wl["word_pen"])
        self.st = build_structure(cfg)
        self.means, self.variances = make_gaussians(cfg, seed, device)
        t = self._phase("structure and Gaussians", t)
        self.comp = _system.hmm_set(cfg, self.st,
                                    self.means.cpu().numpy(),
                                    self.variances.cpu().numpy())
        t = self._phase("compile_hmmset", t)
        self.net = self.build_net()
        t = self._phase("network", t)
        lo, hi = wl["frames"]
        self.pool = make_pool(cfg, self.st, self.means, int(wl["pool"]),
                              int(lo), int(hi), seed)
        self._phase("utterances", t)
        order = np.argsort(self.pool.lengths, kind="stable")
        B = int(wl["batch"])
        groups = [order[i:i + B].tolist() for i in range(0, len(order), B)]
        self.buckets = [groups[k] for k in interleaved(len(groups))]
        self.word_id = {w: k for k, w in enumerate(self.st.words)}
        self.frame_s = float(cfg["frame_s"])
        self.flops_per_frame = _system.gaussian_flops(cfg, self.st)
        rng = np.random.default_rng([int(seed) % (1 << 63), 2])
        self.priority = rng.permutation(len(self.pool.lengths))
        self.calls: List[dict] = []
        self.results: Dict[int, tuple] = {}
        self.n_requests = self.n_failed = 0
        self.window_s = 0.0

    def _phase(self, name: str, t0: float) -> float:
        t = time.perf_counter()
        self.setup_phases.append((name, t - t0))
        return t

    # -- subclasses ------------------------------------------------------
    def build_net(self):
        raise NotImplementedError

    def call(self, feats: List[np.ndarray]) -> list:
        """The timed entry on one bucket; one (words, times, score, extra)
        or None a request, on the host."""
        raise NotImplementedError

    def bounds(self, B: int, T: int, launches: Dict[str, int]) -> dict:
        """Each kernel's roofline bound (ms) over one call's launches."""
        return {}

    def launch_counts(self) -> Dict[str, int]:
        return {}

    def keeps(self, i: int) -> bool:
        """Whether request i's bulky output (a lattice) is kept for the
        check: every request's by default."""
        return True

    # -- the run -----------------------------------------------------------
    def _run(self, idx: List[int]):
        feats = [self.pool.feats[i] for i in idx]
        before = self.launch_counts()
        t0 = time.perf_counter()
        with record_function("hbench.bucket"):
            out = self.call(feats)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        after = self.launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        return out, t1 - t0, launched

    def warm_up(self) -> None:
        """The cell's `warm_up`: one bucket of each padded length the
        traffic uses ("each_length"), or the longest bucket alone
        ("longest": where no operation's build depends on the length, it
        sizes the allocator for every other)."""
        t = time.perf_counter()
        lengths = {pad_T(self.pool.lengths[b]): b for b in self.buckets}
        if self.wl["warm_up"] == "longest":
            lengths = {max(lengths): lengths[max(lengths)]}
        for b in lengths.values():
            self._run(b)
        self._phase(f"warm-up ({len(lengths)} bucket(s))", t)

    def window(self, seconds: float) -> None:
        """Measure for `seconds`; the window's calls replace the last
        window's (its requests join the finished ones)."""
        self.calls = []
        t_start = time.perf_counter()
        k = 0
        while time.perf_counter() - t_start < seconds:
            idx = self.buckets[k % len(self.buckets)]
            k += 1
            out, dt, launched = self._run(idx)
            lens = self.pool.lengths[idx]
            self.calls.append({
                "ms": dt * 1e3, "frames": int(lens.sum()),
                "audio_s": float(lens.sum()) * self.frame_s,
                "launches": launched,
                "bounds": self.bounds(len(idx), pad_T(lens), launched)})
            for i, r in zip(idx, out):
                self.n_requests += 1
                if r is None:
                    self.n_failed += 1
                elif i not in self.results:
                    self.results[i] = r if self.keeps(i) else r[:3] + (
                        None,)
        self.window_s = time.perf_counter() - t_start
        per = [c["ms"] / c["frames"] * 1e3 for c in self.calls]
        q = np.percentile(per, [10, 50, 90]) if per else [0.0] * 3
        self.window_log.append(
            f"window: {len(self.calls)} calls in {self.window_s:.3f} s; "
            f"ms a 1,000 frames p10 {q[0]:.2f}, p50 {q[1]:.2f}, p90 "
            f"{q[2]:.2f}")

    # -- metrics -----------------------------------------------------------
    def end_to_end(self) -> Dict[str, float]:
        audio = sum(c["audio_s"] for c in self.calls)
        return {"decode_audio_s_per_s": rate(audio, self.window_s)}

    def context(self) -> dict:
        """What the per-layer readers read."""
        bounds: Dict[str, float] = {}
        launches: Dict[str, int] = {}
        for c in self.calls:
            for k, v in c["bounds"].items():
                bounds[k] = bounds.get(k, 0.0) + v
            for k, v in c["launches"].items():
                launches[k] = launches.get(k, 0) + v
        frames = sum(c["frames"] for c in self.calls)
        return {"side": self.side, "job": self.job, "window_s": self.window_s,
                "model_flops": frames * self.flops_per_frame,
                "bounds_ms": bounds, "launches": launches,
                "call_ms": [c["ms"] for c in self.calls]}

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        self.comp = self.net = None

    # -- correctness -------------------------------------------------------
    def sample(self) -> List[int]:
        """`check_requests` finished requests, by the seed's priority, with
        the longest finished among them."""
        done = [i for i in self.priority.tolist() if i in self.results
                and (not self.extra or self.results[i][3] is not None)]
        n = int(self.wl["check_requests"])
        pick = done[:n]
        if done:
            longest = max(done, key=lambda i: self.pool.lengths[i])
            if longest not in pick:
                pick = pick[:-1] + [longest] if len(pick) == n else (
                    pick + [longest])
        return pick

    def reference(self):
        trans = transitions(self.cfg)
        return ref.WordLoop(self.st.word_states, self.st.succ,
                            lm_weights(self.cfg), trans, self.lm_scale,
                            self.word_pen, self.device)

    def check(self) -> List[tuple]:
        """(name, value, limit) of each number compared:

          score_gap       the widest |program's score - reference's best| of
                          a sampled request, in units of float32's rounding
                          of the running score: 2^-24 x |best| x T / 2 (T
                          frames whose partial sums grow to |best|). The
                          recursion in float32 drifts by a fixed share of
                          that (its self-loop add rounds the same way every
                          frame); a lower precision adds error on top
          paths_not_best  requests whose words and word times the reference
                          scores below its best by more than NOT_BEST of it
                          (an exact comparison: a path is a best path or not)

        and what a subclass's `check_output` adds.
        """
        pick = self.sample()
        loop = self.reference()
        lim = self.wl["limits"]
        got = {k: 0.0 for k in lim}
        blk = int(self.wl["check_block"])
        for i0 in range(0, len(pick), blk):
            part = pick[i0:i0 + blk]
            lls = [ref.state_loglik(
                torch.as_tensor(self.pool.feats[i], device=self.device),
                self.means, self.variances) for i in part]
            best, ends = ref.best_scores(loop, lls, ends=True) if \
                self.extra else (ref.best_scores(loop, lls), None)
            res = [self.results[i] for i in part]
            path = ref.path_scores(loop, lls, [(r[0], r[1]) for r in res],
                                   self.st.word_states)
            for b, (i, r) in enumerate(zip(part, res)):
                rounding = F32_U * abs(best[b]) * self.pool.lengths[i] / 2
                got["score_gap"] = max(got["score_gap"],
                                       _rel(r[2], best[b], rounding))
                got["paths_not_best"] += float(
                    _rel(path[b], best[b], abs(best[b])) > NOT_BEST)
                if self.extra:
                    self.check_output(got, loop, r[3], lls[b],
                                      ends[b], best[b], rounding)
            del lls, ends
        self.checked = len(pick)
        return [(k, got[k], float(lim[k])) for k in lim]

    def check_output(self, got, loop, extra, ll, ends, best,
                     rounding) -> None:
        """Fold one sampled request's bulky output (`extra`) into `got`,
        with its frames' log-likelihoods `ll`, the reference's word-end
        plane `ends` (T, V) and best score."""


def _rel(x: float, y: float, scale: float) -> float:
    """|x - y| / scale; a missing or infinite score reads 1e30."""
    if not (math.isfinite(x) and math.isfinite(y)):
        return 1e30
    return abs(x - y) / scale
