"""HDecode's pass 1: `algo.decode.generate_lattice_batch` on the factored
uniform-row loop that `algo.lvnet.compile_lv_loop` builds from the ARPA
bigram and the triphone dictionary, with the 1-best and a lattice of each
utterance (tools/hdecode.py's batched LV path), a batch a call."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from htk_tpu_torch.algo.decode import generate_lattice_batch
from htk_tpu_torch.algo.lvnet import compile_lv_loop
from htk_tpu_torch.ops import xw_gather as xg

from ..metrics._bounds import segmax_bound
from ..reference import decoder as ref
from . import _system
from ._decoding import F32_U, DecodingJob, _rel


MAXC = 64  # the candidate predecessors a walk examines at an entry frame
LM_OFF = 1e-3  # an arc's LM score this far from the reference's is wrong


@dataclass
class LatticeArrays:
    """A lattice as plain arrays. Nodes: the frame a record ends on (the
    start node -1) and its word (-1 for !NULL); arcs: their nodes and
    scores; the start and end nodes (no incoming / no outgoing arc)."""

    t: np.ndarray
    word: np.ndarray
    a_start: np.ndarray
    a_end: np.ndarray
    ac: np.ndarray
    lm: np.ndarray
    start: int
    end: int


def lattice_arrays(lat, word_id, frame_s: float) -> LatticeArrays:
    pos = {n.id: k for k, n in enumerate(lat.nodes)}
    a_start = np.array([pos[a.start] for a in lat.arcs], np.int64)
    a_end = np.array([pos[a.end] for a in lat.arcs], np.int64)
    has_in = np.zeros(len(lat.nodes), bool)
    has_out = np.zeros(len(lat.nodes), bool)
    has_in[a_end] = True
    has_out[a_start] = True
    return LatticeArrays(
        t=np.array([round(n.time / frame_s) - 1 for n in lat.nodes],
                   np.int64),
        word=np.array([word_id.get(n.word, -1) for n in lat.nodes],
                      np.int64),
        a_start=a_start, a_end=a_end,
        ac=np.array([a.aclike for a in lat.arcs], np.float64),
        lm=np.array([a.lmlike for a in lat.arcs], np.float64),
        start=int(np.nonzero(~has_in)[0][0]),
        end=int(np.nonzero(~has_out)[0][0]))


class Job(DecodingJob):
    job = "lattice"
    extra = True

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.kept = set(self.priority[:int(self.wl["keep_requests"])].tolist())
        self.longest_kept = 0

    def build_net(self):
        return compile_lv_loop(
            self.st.words, _system.vocab(self.st, triphones=True), self.comp,
            lm=_system.arpa_lm(self.cfg, self.st),
            factored=bool(self.wl["factored"]))

    def keeps(self, i):
        n = int(self.pool.lengths[i])
        if i in self.kept or n >= self.longest_kept:
            self.kept.add(i)
            self.longest_kept = max(self.longest_kept, n)
            return True
        return False

    def call(self, feats):
        wl = self.wl
        prs = generate_lattice_batch(
            self.net, self.comp, feats, self.lm_scale, self.word_pen,
            lattice_beam=float(wl["lattice_beam"]),
            frame_period_s=self.frame_s, precision=self.precision,
            max_preds=int(wl["lat_preds"]), want_results=True,
            device=self.device)
        return [None if (r is None or lat is None) else
                ([self.word_id[w] for w in r.words], r.times, r.score, lat)
                for lat, r in prs]

    def check_output(self, got, loop, lat, ll, ends, best,
                     rounding):
        """The lattice against the reference, every arc of it:

          lattice_gap   |lattice's best path - reference's best|, in the
                        units of score_gap
          arc_gap       the widest |arc's acoustic score - the reference's
                        Viterbi score of its word inside its frames|, in
                        units of float32's rounding of the running score
                        over the arc: 2^-24 x |word-end score| x (frames +
                        2) (an arc's score is the difference of two
                        running scores, each rounded on every frame); the
                        arcs into the end node score 0 against one
                        rounding of |best|
          arc_lm_off    arcs whose LM score is not the reference's for
                        their two words (sentence start and end included)
                        within LM_OFF
          alts_missing  records that lack an alternative predecessor the
                        walk has to keep: a record at the entry frame,
                        among its MAXC best, within the lattice beam of the
                        record's own score and better than the worst
                        predecessor kept (or fewer than LATPREDS kept), each
                        by more than one rounding of the running score
        """
        L = lattice_arrays(lat, self.word_id, self.frame_s)
        got["lattice_gap"] = max(got["lattice_gap"], _rel(ref.lattice_best(
            L.t, L.a_start, L.a_end, L.ac, L.lm, L.start, L.end,
            self.lm_scale, self.word_pen), best, rounding))
        fin = L.a_end == L.end
        beg = L.a_start == L.start
        mid = ~fin
        w = L.word[L.a_end[mid]]
        t1 = L.t[L.a_end[mid]]
        t0 = np.where(beg[mid], 0, L.t[L.a_start[mid]] + 1)
        seg = ref.segment_scores(loop, ll, self.st.word_states, w, t0, t1)
        wend = ends[torch.as_tensor(t1, device=ends.device),
                    torch.as_tensor(w, device=ends.device)].cpu().numpy()
        unit = F32_U * np.abs(wend) * (t1 - t0 + 3)
        gap = np.abs(L.ac[mid] - seg) / unit
        gap_fin = np.abs(L.ac[fin]) / (F32_U * abs(best))
        got["arc_gap"] = max(got["arc_gap"], float(np.max(gap, initial=0)),
                             float(np.max(gap_fin, initial=0)))
        # each arc's LM score: the grammar's for its two words
        lm_ref = np.empty(len(L.lm))
        lm_ref[fin] = loop.lm["end"]
        lm_ref[beg & mid] = loop.lm["start"]
        inner = ~fin & ~beg
        lm_ref[inner] = loop.lm_pairs(L.word[L.a_start[inner]],
                                      L.word[L.a_end[inner]])
        got["arc_lm_off"] += float(np.sum(np.abs(L.lm - lm_ref) > LM_OFF))
        got["alts_missing"] += float(self._alts_missing(
            L, ends, inner[mid], seg, loop))

    def _alts_missing(self, L, ends, inner_of_mid, seg, loop) -> int:
        """How many records lack an alternative predecessor (see
        check_output); `seg` holds the reference's score of each non-final
        arc's word inside its frames."""
        s, p = self.lm_scale, self.word_pen
        beam = float(self.wl["lattice_beam"])
        keep = int(self.wl["lat_preds"])
        mid = L.a_end != L.end
        a_s = L.a_start[mid][inner_of_mid]
        a_e = L.a_end[mid][inner_of_mid]
        seg_e = seg[inner_of_mid]
        if not a_e.size:
            return 0
        recs, first = np.unique(a_e, return_index=True)
        seg_r = seg_e[first]
        pt_r = L.t[a_s[first]]
        t_r, w_r = L.t[recs], L.word[recs]
        dev = ends.device
        own = ends[torch.as_tensor(t_r, device=dev),
                   torch.as_tensor(w_r, device=dev)].cpu().numpy()
        margin = F32_U * np.abs(own) * (t_r + 1) / 2
        is_rec = L.word >= 0
        N = len(L.t)
        present = np.unique(a_e * N + a_s)
        missing = 0
        for pt in np.unique(pt_r).tolist():
            cand = np.nonzero(is_rec & (L.t == pt))[0]
            if cand.size < 2:
                continue
            d = ends[pt, torch.as_tensor(L.word[cand], device=dev)].cpu(
            ).numpy()
            rows = np.nonzero(pt_r == pt)[0]
            m = margin[rows]
            top = True  # among the MAXC best at the entry frame
            if cand.size > MAXC:
                top = d[None, :] > np.sort(d)[-(MAXC + 1)] + m[:, None]
            lm = loop.lm_pairs(np.tile(L.word[cand], rows.size),
                               np.repeat(w_r[rows], cand.size)).reshape(
                                   rows.size, cand.size)
            alt = d[None, :] + s * lm + p + seg_r[rows][:, None]
            has = np.isin(recs[rows][:, None] * N + cand[None, :], present)
            n_in = has.sum(1)
            worst = np.where(has, alt, np.inf).min(1)
            elig = (~has & top & (alt >= (own[rows] - beam + m)[:, None]))
            room = n_in < keep
            miss = elig & (room[:, None] | (alt > (worst + m)[:, None]))
            missing += int(miss.any(1).sum())
        return missing

    def launch_counts(self):
        return {"segmax": xg.SEGMAX.launches}

    def bounds(self, B, T, launched):
        x = self.net.xw_backoff
        N = sum(p.size for p, _ in x["buckets"])
        return {"segmax": launched.get("segmax", 0) * segmax_bound(
            B, len(self.st.words), N, len(x["inv"]))}
