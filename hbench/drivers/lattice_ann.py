"""HDecode -N: pass 1 with a hybrid DNN-HMM. Each batch is the two stages
of the port's HDecode -N batch: `algo.nnet.hybrid_outp` on the batch's
padded frames (the DNN's log posteriors minus log priors, on the device),
then `algo.decode.generate_lattice_batch(state_scores_list=...)` on the
factored LV loop of `drivers/lattice.py`, whose lattices and checks this
job keeps.

The DNN is generated from the seed: `hidden` layers of `activation` units
over `context` frames each side, one output a tied state of the set (in
the order the set's states first appear, the order the program's
compiled set numbers them: `algo.nnet.check_targets` holds the program to
it), weights and biases N(0, weight_gain^2 / fan-in), priors a
Dirichlet(1) draw. The traffic's GMM only draws the frames: it is never
the model.

The window keeps up to `keep_requests` lattices for the check, each tens
of thousands of Python objects. Before each call they move to the
collector's permanent generation (`gc.freeze`, as `run.py` does with
set-up's objects), so that the window's collections walk the program's
objects and not the growing store of kept lattices, which a deployment
that writes its lattices out does not hold.

The check scores the sampled requests with the plain float64 DNN
(`reference/ann.py`) in place of the GMM's log-likelihoods, and adds

Its scores are log posteriors over priors, of either sign, so a running
score can pass near zero on its way to a best score of a few hundred:
float32 rounds it on each frame at the size it has then. Every rounding
unit of the lattice job (score_gap, lattice_gap, arc_gap, the margin of
alts_missing) and the scale of paths_not_best take the larger of its
own score and the utterance's largest |best word end| of a frame (the
reference's) in place of that score alone; on the GMM cells' falling
scores the two are the same.

  ann_gap   the widest |program - reference| over the kept score rows
            (the last frame and 3 seeded frames of every utterance, taken
            inside the timed call from the plane it computed), in units of
            ANN_U x float32's rounding of the output layer's dot product,
            2^-24 x sum_k |W_jk h_k| with the reference's h. ANN_U = 4
            allows for the earlier layers' rounding, which reaches the
            output through W, and the log-softmax's and the prior's
            roundings of the score. TF32 in the matmuls rounds their
            inputs to 2^-11 and reads hundreds of these units.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from htk_tpu_torch.algo.decode import generate_lattice_batch
from htk_tpu_torch.algo.nnet import check_targets, hybrid_outp
from htk_tpu_torch.models.ann import ANNDef, ANNModule, Layer

from ..reference import ann as ref_ann
from ..reference import decoder as ref
from ..traffic.synth import _generator
from . import lattice
from ._decoding import F32_U, NOT_BEST, _rel, pad_T

ANN_U = 4.0  # the unit's allowance for what precedes the output layer
KEEP_FRAMES = 3  # seeded frames kept a request, besides its last


def target_order(st) -> np.ndarray:
    """The pool states in the order the set's states first appear (its
    triphones by name, each one's states in turn): DNN output k scores
    pool state order[k]."""
    flat = st.tri_states.reshape(-1)
    _, first = np.unique(flat, return_index=True)
    return flat[np.sort(first)]


def make_dnn(cfg: dict, n_in: int, n_out: int, seed: int, device):
    """[(W, b, activation)] float32 on `device` and the priors, from
    `seed`."""
    g = _generator(int(seed) + 3, device)
    dims = [n_in * (2 * int(cfg["context"]) + 1), *cfg["hidden"], n_out]
    gain = float(cfg["weight_gain"])
    layers = []
    for k in range(len(dims) - 1):
        sd = gain / dims[k] ** 0.5
        W = torch.randn((dims[k + 1], dims[k]), generator=g,
                        device=device) * sd
        b = torch.randn((dims[k + 1],), generator=g, device=device) * sd
        layers.append((W, b, cfg["activation"] if k < len(dims) - 2
                       else "SOFTMAX"))
    e = -torch.log(torch.rand((n_out,), generator=g, device=device,
                              dtype=torch.float64))  # Dirichlet(1)
    return layers, (e / e.sum()).to(torch.float32)


def _member(q: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Whether each of q is in the sorted array `keys`."""
    pos = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    return keys[pos] == q


class Job(lattice.Job):
    job = "lattice"

    def __init__(self, cell, seed, device, control=False):
        super().__init__(cell, seed, device, control)
        t = time.perf_counter()
        cfg = self.cfg
        self.order = target_order(self.st)
        self.layers, self.priors = make_dnn(cfg, int(cfg["dim"]),
                                            len(self.order), seed, device)
        ann = ANNDef(
            name="dnn", context=int(cfg["context"]),
            layers=[Layer(weight=W.cpu().numpy(), bias=b.cpu().numpy(),
                          activation=a) for W, b, a in self.layers],
            target_priors=self.priors.cpu().numpy(),
            target_names=[f"st{k}" for k in self.order])
        check_targets(ann, self.comp)
        self.ann, self.model = ann, ANNModule(ann, device)
        self.flops_per_frame = 2.0 * sum(W.numel() for W, _, _ in
                                         self.layers)
        self.ann_rows: Dict[int, tuple] = {}
        self.idx = []
        self._phase("DNN", t)

    def _run(self, idx):
        self.idx = idx
        gc.freeze()  # the kept results (the module's docstring)
        return super()._run(idx)

    def call(self, feats):
        lens = [len(f) for f in feats]
        fb = np.zeros((len(feats), pad_T(lens), feats[0].shape[1]),
                      np.float32)
        for b, f in enumerate(feats):
            fb[b, :lens[b]] = f
        scores = hybrid_outp(self.ann, fb, device=self.device,
                             model=self.model, lengths=lens,
                             precision=self.precision)
        self._keep_rows(scores, lens)
        wl = self.wl
        prs = generate_lattice_batch(
            self.net, self.comp, feats, self.lm_scale, self.word_pen,
            lattice_beam=float(wl["lattice_beam"]),
            frame_period_s=self.frame_s, precision=self.precision,
            max_preds=int(wl["lat_preds"]), want_results=True,
            state_scores_list=scores, device=self.device)
        return [None if (r is None or lat is None) else
                ([self.word_id[w] for w in r.words], r.times, r.score, lat)
                for lat, r in prs]

    def _frames(self, i: int, n: int) -> np.ndarray:
        rng = np.random.default_rng([int(self.seed) % (1 << 63), 4, i])
        return np.append(rng.choice(n - 1, KEEP_FRAMES, replace=False),
                         n - 1)

    def _keep_rows(self, scores, lens):
        """Each new request's kept score rows, gathered on the device."""
        new = [(b, i) for b, i in enumerate(self.idx)
               if i not in self.ann_rows]
        if not new:
            return
        fr = [self._frames(i, lens[b]) for b, i in new]
        bi = np.repeat([b for b, _ in new], KEEP_FRAMES + 1)
        rows = scores[torch.as_tensor(bi, device=scores.device),
                      torch.as_tensor(np.concatenate(fr),
                                      device=scores.device)]
        for k, (b, i) in enumerate(new):
            self.ann_rows[i] = (fr[k], rows[k * (KEEP_FRAMES + 1):
                                            (k + 1) * (KEEP_FRAMES + 1)])

    def release(self):
        super().release()
        self.ann = self.model = None

    def check(self):
        """As `DecodingJob.check` and the lattice job's `check_output`,
        with the reference DNN's scores in place of the GMM's
        log-likelihoods, and `ann_gap` (the module's docstring)."""
        pick = self.sample()
        loop = self.reference()
        dnn = ref_ann.DNN(self.layers, self.priors,
                          int(self.cfg["context"]), self.device)
        pool = torch.as_tensor(self.order, device=self.device)
        lim = self.wl["limits"]
        got = {k: 0.0 for k in lim}
        blk = int(self.wl["check_block"])
        for i0 in range(0, len(pick), blk):
            part = pick[i0:i0 + blk]
            lls = []
            for i in part:
                s = dnn.scores(self.pool.feats[i])
                ll = s.new_full((s.shape[0], int(self.cfg["n_tied"])),
                                float("-inf"))
                ll[:, pool] = s
                lls.append(ll)
            best, ends = ref.best_scores(loop, lls, ends=True)
            res = [self.results[i] for i in part]
            path = ref.path_scores(loop, lls, [(r[0], r[1]) for r in res],
                                   self.st.word_states)
            for b, (i, r) in enumerate(zip(part, res)):
                n = int(self.pool.lengths[i])
                lead = ends[b, :n].max(dim=1).values
                self.mag = float(lead[torch.isfinite(lead)].abs().max())
                rounding = F32_U * max(abs(best[b]), self.mag) * n / 2
                got["score_gap"] = max(got["score_gap"],
                                       _rel(r[2], best[b], rounding))
                got["paths_not_best"] += float(_rel(
                    path[b], best[b], max(abs(best[b]), self.mag))
                    > NOT_BEST)
                self.check_output(got, loop, r[3], lls[b], ends[b],
                                  best[b], rounding)
            del lls, ends
        for i in pick:
            fr, rows = self.ann_rows[i]
            want, scale = dnn.rows(self.pool.feats[i], fr)
            unit = ANN_U * F32_U * scale
            gap = ((rows.to(torch.float64) - want).abs() / unit).max()
            got["ann_gap"] = max(got["ann_gap"], float(gap))
        self.checked = len(pick)
        return [(k, got[k], float(lim[k])) for k in lim]

    def check_output(self, got, loop, lat, ll, ends, best, rounding):
        """The lattice job's `check_output`, its units on the larger of a
        score and `self.mag`, the utterance's largest |best word end|."""
        L = lattice.lattice_arrays(lat, self.word_id, self.frame_s)
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
        unit = F32_U * np.maximum(np.abs(wend), self.mag) * (t1 - t0 + 3)
        gap = np.abs(L.ac[mid] - seg) / unit
        gap_fin = np.abs(L.ac[fin]) / (F32_U * max(abs(best), self.mag))
        got["arc_gap"] = max(got["arc_gap"], float(np.max(gap, initial=0)),
                             float(np.max(gap_fin, initial=0)))
        lm_ref = np.empty(len(L.lm))
        lm_ref[fin] = loop.lm["end"]
        lm_ref[beg & mid] = loop.lm["start"]
        inner = ~fin & ~beg
        lm_ref[inner] = loop.lm_pairs(L.word[L.a_start[inner]],
                                      L.word[L.a_end[inner]])
        got["arc_lm_off"] += float(np.sum(np.abs(L.lm - lm_ref)
                                          > lattice.LM_OFF))
        got["alts_missing"] += float(self._alts_missing(
            L, ends, inner[mid], seg, loop))

    def _alts_missing(self, L, ends, inner_of_mid, seg, loop) -> int:
        """The lattice job's `_alts_missing`, its margin on the larger of
        a record's own score and `self.mag`, and the arcs looked up in
        their sorted keys (a hybrid lattice holds several times the GMM
        cell's alternative arcs)."""
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
        margin = F32_U * np.maximum(np.abs(own), self.mag) * (t_r + 1) / 2
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
            if cand.size > lattice.MAXC:
                top = d[None, :] > np.sort(d)[-(lattice.MAXC + 1)] + \
                    m[:, None]
            lm = loop.lm_pairs(np.tile(L.word[cand], rows.size),
                               np.repeat(w_r[rows], cand.size)).reshape(
                                   rows.size, cand.size)
            alt = d[None, :] + s * lm + p + seg_r[rows][:, None]
            has = _member(recs[rows][:, None] * N + cand[None, :], present)
            n_in = has.sum(1)
            worst = np.where(has, alt, np.inf).min(1)
            elig = (~has & top & (alt >= (own[rows] - beam + m)[:, None]))
            room = n_in < keep
            miss = elig & (room[:, None] | (alt > (worst + m)[:, None]))
            missing += int(miss.any(1).sum())
        return missing
