"""HHEd — HMM definition editor (model surgery).

Mirrors `HTKTools/HHEd.c` (SURVEY.md §3.4): a script of edit commands
applied to a loaded HMMSet. Implemented commands:

  TR n                    set trace level
  QS 'name' { p1,p2,.. }  define a context question
  RO f [statsfile]        outlier threshold + load state occupancies
  LS statsfile            load state occupancies
  CL hmmlist              clone monophones into the triphones of hmmlist
  TI macro itemlist       tie items to a shared macro
  TB f macro itemlist     decision-tree cluster + tie states
  AU hmmlist              add unseen triphones by tree lookup
  ST file                 save question set + trees
  LT file                 load question set + trees
  MU n itemlist           mixture-up splitting (n or +n)
  AT i j p itemlist       add transition i->j with prob p (row renormalised)
  RT i j itemlist         remove transition i->j
  SS n                    split the data stream into n streams
  SW s n                  set width of stream s to n
  RC n name               build n regression base classes -> name.cls
  NC n macro itemlist     data-driven bottom-up state clustering + tie
  TC f macro itemlist     threshold-stopped bottom-up clustering + tie
  DP s n id1..idn         duplicate the set n times (s: macro types that
                          get private copies; others stay shared)
  XF tmf                  attach an input transform to the model set
  SU n w1..wn             split the data stream into n streams of the
                          given widths
  PS n p                  allocate mixtures per state ~ n*occ^p (needs
                          LS stats)
  UT itemlist             untie (private copies of shared states)
  FV file                 load + apply variance floors (vFloors)
  RN id                   rename the HMM-set identifier
  JO size floor           tied-mixture join parameters for HK TIEDHS
  HK kind                 convert set kind (DISCRETEHS / TIEDHS / ...)
  SH                      show summary

Usage: python -m htk_tpu_torch.tools.hhed [options] edScript hmmList

  -H mmf   load HMM macro file (repeatable)
  -M dir   output directory
  -w list  write the updated model list
  Standard: -A -B -C -D -S -T -V

Copied from `htk_tpu/tools/hhed.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX. RC and XF use the port's algo/adapt.py.
"""

from __future__ import annotations

import os
import re
import shlex
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..algo.tree import (Question, Tree, build_tree, classify, load_trees,
                         parse_triphone, save_trees, state_stats)
from ..io.mmf import HMMDef, HMMSet, MixPDF, StateInfo, StreamElem, load_hmm_list, load_mmf, save_mmf
from ..models.itemlist import Item, parse_item_list
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, HRError


USAGE = "Usage: HHEd [options] edScript hmmList"

OPTS = {
    "H": Option("H", 1, "load MMF", repeatable=True),
    "M": Option("M", 1, "output directory"),
    "w": Option("w", 1, "write updated model list"),
}


class Editor:
    def __init__(self, hset: HMMSet, trace: int = 0, cfg=None):
        self.hset = hset
        self.trace = trace
        self.cfg = cfg
        self.questions: List[Question] = []
        self.qdict: Dict[str, Question] = {}
        self.trees: List[Tree] = []
        self.stats: Dict[Tuple[str, int], float] = {}  # (hmm, state) -> occ
        self.ro_threshold = 0.0
        self.jo_size: Optional[int] = None  # JO: tied-mixture pool size
        self.jo_floor: Optional[float] = None  # JO: weight floor
        self.baseclasses: Dict[str, tuple] = {}  # fname -> (macro, classes)

    # -- commands --------------------------------------------------------

    def cmd_qs(self, name: str, patterns: List[str]):
        q = Question(name=name, patterns=patterns)
        self.questions.append(q)
        self.qdict[name] = q

    def cmd_ls(self, path: str):
        for ln in open(path):
            parts = shlex.split(ln)
            if len(parts) < 4:
                continue
            name = parts[1]
            occs = [float(x) for x in parts[3:]]
            for k, occ in enumerate(occs):
                self.stats[(name, k + 2)] = occ
        if self.trace:
            print(f"HHEd: loaded stats for {len(self.stats)} states")

    def cmd_ro(self, thresh: float, path: Optional[str]):
        self.ro_threshold = thresh
        if path:
            self.cmd_ls(path)

    def cmd_cl(self, list_path: str):
        names = [l for l, p in load_hmm_list(list_path, self.cfg)]
        hset = self.hset
        n_new = 0
        for nm in names:
            if nm in hset.hmms:
                continue
            _, base, _ = parse_triphone(nm)
            src = hset.hmms.get(base)
            if src is None:
                HError(2662, "CL: no source model %s for %s", base, nm)
            hset.hmms[nm] = _deep_clone(src, nm)
            hset.macros["h"][nm] = hset.hmms[nm]
            n_new += 1
        if self.trace:
            print(f"HHEd: CL cloned {n_new} models from {list_path}")

    def cmd_ti(self, macro: str, spec: str):
        items = parse_item_list(spec, self.hset)
        kind = items[0].kind
        if kind == "transP":
            shared = items[0].hmm.transp
            self.hset.macros["t"][macro] = shared
            for it in items[1:]:
                it.hmm.transp = shared
        elif kind == "state":
            # HTK ties to the state with max occupancy if stats loaded,
            # else the first item
            best = items[0]
            if self.stats:
                best = max(
                    items,
                    key=lambda it: self.stats.get((it.hmm.name, it.state_idx), 0.0),
                )
            shared = best.hmm.states[best.state_idx - 2]
            self.hset.macros["s"][macro] = shared
            for it in items:
                it.hmm.states[it.state_idx - 2] = shared
        elif kind == "mean":
            shared = None
            for it in items:
                mp = _get_mix(it)
                if shared is None:
                    shared = mp.mean
                    self.hset.macros["u"][macro] = shared
                mp.mean = shared
        elif kind == "cov":
            shared = None
            for it in items:
                mp = _get_mix(it)
                if shared is None:
                    shared = mp.var
                    self.hset.macros["v"][macro] = shared
                mp.var = shared
        else:
            HError(2640, "TI: unsupported item kind %s", kind)
        if self.trace:
            print(f"HHEd: TI {macro} tied {len(items)} {kind} items")

    def cmd_tb(self, thresh: float, macro: str, spec: str):
        if not self.questions:
            HError(2663, "TB: no questions defined (QS first)")
        items = parse_item_list(spec, self.hset)
        if items[0].kind != "state":
            HError(2640, "TB: item list must select states")
        # all items must be distinct physical states with 1-mix streams
        entries = []
        state_idx = items[0].state_idx
        base = parse_triphone(items[0].hmm.name)[1]
        for it in items:
            occ = self.stats.get((it.hmm.name, it.state_idx), 1.0)
            si = it.hmm.states[it.state_idx - 2]
            if len(si.streams[0].mixes) != 1:
                HError(2663, "TB: states must be single-Gaussian (run before MU)")
            entries.append((it.hmm.name, state_stats(si, occ)))
        tree, leaf_members = build_tree(
            base, state_idx, entries, self.questions, thresh,
            min_occ=self.ro_threshold,
        )
        # create tied states with pooled parameters per leaf
        name_to_item = {(it.hmm.name): it for it in items}
        for k, leaf_node in enumerate(tree._leaves):  # type: ignore[attr-defined]
            mac = f"{macro}{k + 1}"
            leaf_node.macro = mac
            members = leaf_members[k]
            sts = [
                (name_to_item[nm].hmm.states[state_idx - 2],
                 self.stats.get((nm, state_idx), 1.0))
                for nm in members
            ]
            shared = _pooled_state(sts)
            self.hset.macros["s"][mac] = shared
            for nm in members:
                name_to_item[nm].hmm.states[state_idx - 2] = shared
        self.trees.append(tree)
        if self.trace:
            print(
                f"HHEd: TB {macro} clustered {len(entries)} states -> "
                f"{len(leaf_members)} tied states (thresh {thresh})"
            )

    def cmd_au(self, list_path: str):
        names = [l for l, p in load_hmm_list(list_path, self.cfg)]
        by_phone: Dict[Tuple[str, int], Tree] = {}
        for t in self.trees:
            by_phone[(t.base_phone, t.state_idx)] = t
        n_new = 0
        for nm in names:
            if nm in self.hset.hmms:
                continue
            _, base, _ = parse_triphone(nm)
            src = self.hset.hmms.get(base)
            if src is None:
                # source any existing triphone of this phone for topology
                for cand in self.hset.hmms.values():
                    if parse_triphone(cand.name)[1] == base:
                        src = cand
                        break
            if src is None:
                HRError(2661, "AU: no tree/source for %s", nm)
                continue
            h = HMMDef(name=nm, nstates=src.nstates)
            h.transp = src.transp  # share (usually a tied ~t macro already)
            for s in range(2, src.nstates):
                tr = by_phone.get((base, s))
                if tr is None:
                    h.states.append(src.states[s - 2])
                    continue
                mac = classify(tr, self.qdict, nm)
                shared = self.hset.macros["s"].get(mac)
                if shared is None:
                    HError(2662, "AU: tree leaf %s has no tied state", mac)
                h.states.append(shared)
            self.hset.hmms[nm] = h
            self.hset.macros["h"][nm] = h
            n_new += 1
        if self.trace:
            print(f"HHEd: AU added {n_new} unseen models from {list_path}")

    def cmd_mu(self, target: str, spec: str):
        items = parse_item_list(spec, self.hset)
        # operate at stream level: group mix items by their stream
        streams = []
        seen = set()
        for it in items:
            si = it.hmm.states[it.state_idx - 2]
            se = si.streams[it.stream_idx - 1]
            if id(se) not in seen:
                seen.add(id(se))
                streams.append(se)
        rng = np.random.default_rng(0)
        for se in streams:
            cur = len([m for m in se.mixes if m is not None])
            tgt = cur + int(target[1:]) if target.startswith("+") else int(target)
            while cur < tgt:
                _split_heaviest(se)
                cur += 1
        if self.trace:
            print(f"HHEd: MU {target} over {len(streams)} streams")

    def cmd_at(self, i: int, j: int, prob: float, spec: str):
        """AT i j prob {transP items}: add transition, renormalise row."""
        items = parse_item_list(spec, self.hset)
        for it in items:
            if it.kind == "hmm":
                it.kind = "transP"
        seen = set()
        for it in items:
            tp = it.hmm.transp
            if id(tp) in seen:
                continue
            seen.add(id(tp))
            n = tp.shape[0]
            if not (1 <= i <= n and 1 <= j <= n):
                HError(2632, "AT: transition %d->%d outside 1..%d", i, j, n)
            tp[i - 1, j - 1] = prob
            row = tp[i - 1]
            other = row.sum() - prob
            if other > 0:
                scale = (1.0 - prob) / other
                tp[i - 1] = row * scale
                tp[i - 1, j - 1] = prob
        if self.trace:
            print(f"HHEd: AT {i} {j} {prob} over {len(seen)} transP")

    def cmd_rt(self, i: int, j: int, spec: str):
        """RT i j {transP items}: remove transition, renormalise row."""
        items = parse_item_list(spec, self.hset)
        seen = set()
        for it in items:
            tp = it.hmm.transp
            if id(tp) in seen:
                continue
            seen.add(id(tp))
            tp[i - 1, j - 1] = 0.0
            s = tp[i - 1].sum()
            if s > 0:
                tp[i - 1] /= s
        if self.trace:
            print(f"HHEd: RT {i} {j} over {len(seen)} transP")

    def cmd_co(self, list_path: str):
        """CO: compact — merge physically identical HMMs, write the new
        list with `logical physical` lines (HHEd.c CompactSet)."""
        hset = self.hset
        # identity signature: shared state ids + transP id
        sig_of = {}
        phys_of = {}
        for nm, h in hset.hmms.items():
            sig = (tuple(id(s) for s in h.states), id(h.transp), h.nstates)
            if sig in sig_of:
                phys_of[nm] = sig_of[sig]
            else:
                sig_of[sig] = nm
                phys_of[nm] = nm
        with open(list_path, "w") as f:
            for nm in hset.hmms:
                if phys_of[nm] == nm:
                    f.write(f"{nm}\n")
                else:
                    f.write(f"{nm} {phys_of[nm]}\n")
        # drop duplicate physical definitions (logical entries stay in list)
        keep = {phys_of[nm] for nm in hset.hmms}
        removed = [nm for nm in list(hset.hmms) if nm not in keep]
        for nm in removed:
            del hset.hmms[nm]
            hset.macros["h"].pop(nm, None)
        if self.trace:
            print(f"HHEd: CO {len(removed)} logical models share physical "
                  f"definitions -> {list_path}")

    def cmd_md(self, target: int, spec: str):
        """MD n: mixture-down — remove lowest-weight mixtures to n."""
        items = parse_item_list(spec, self.hset)
        seen = set()
        n_done = 0
        for it in items:
            si = it.hmm.states[it.state_idx - 2]
            se = si.streams[it.stream_idx - 1]
            if id(se) in seen:
                continue
            seen.add(id(se))
            while sum(1 for m in se.mixes if m is not None) > target:
                live = [(i, w) for i, (w, m) in
                        enumerate(zip(se.weights, se.mixes)) if m is not None]
                i, w = min(live, key=lambda t: t[1])
                se.mixes[i] = None
                se.weights[i] = 0.0
            tot = sum(w for w, m in zip(se.weights, se.mixes) if m is not None)
            if tot > 0:
                se.weights = [w / tot if m is not None else 0.0
                              for w, m in zip(se.weights, se.mixes)]
            n_done += 1
        if self.trace:
            print(f"HHEd: MD {target} over {n_done} streams")

    def cmd_ss(self, n: int):
        """SS n: split the single data stream into n streams.

        Widths divide the vector evenly (HTK's SetStreamWidths applies
        parmKind-aware splits; even division covers the common USER/MFCC
        cases and is flagged [LC] pending reference verification). Every
        Gaussian is sliced into per-stream components; mixture weights
        replicate per stream.
        """
        hset = self.hset
        if len(hset.swidth) != 1:
            HError(2640, "SS: set already has %d streams", len(hset.swidth))
        D = hset.vec_size
        if D % n:
            HError(2640, "SS: vector size %d not divisible into %d streams",
                   D, n)
        w = D // n
        hset.stream_widths = [w] * n
        done = set()
        for h in hset.hmms.values():
            for si in h.states:
                if id(si) in done:
                    continue
                done.add(id(si))
                src = si.streams[0]
                streams = []
                for s in range(n):
                    se = StreamElem()
                    for wt, mp in zip(src.weights, src.mixes):
                        if mp is None:
                            se.mixes.append(None)
                            se.weights.append(0.0)
                            continue
                        nmp = MixPDF(
                            mean=mp.mean[s * w : (s + 1) * w].copy(),
                            var=mp.var[s * w : (s + 1) * w].copy(),
                            cov_kind=mp.cov_kind,
                        )
                        nmp.fix_gconst()
                        se.mixes.append(nmp)
                        se.weights.append(wt)
                    streams.append(se)
                si.streams = streams
        if self.trace:
            print(f"HHEd: SS split into {n} streams of width {w}")

    def cmd_sw(self, s: int, width: int):
        """SW s n: set the width of stream s to n.

        Mirrors HTK's SetStreamWidthCommand: every Gaussian in stream s is
        resized — truncated when shrinking, padded (mean 0, variance 1)
        when growing — and the set's vector size becomes the new width
        sum. Pad values are flagged [LC] pending reference verification.
        """
        hset = self.hset
        widths = list(hset.swidth)
        if not (1 <= s <= len(widths)):
            HError(2640, "SW: stream %d out of range (set has %d)",
                   s, len(widths))
        if width <= 0:
            HError(2640, "SW: width must be positive, got %d", width)
        old = widths[s - 1]
        done = set()
        for h in hset.hmms.values():
            for si in h.states:
                se = si.streams[s - 1]
                for mp in se.mixes:
                    if mp is None or id(mp) in done:
                        continue
                    done.add(id(mp))
                    d = mp.mean.shape[0]
                    if width <= d:
                        mp.mean = mp.mean[:width].copy()
                        mp.var = mp.var[:width].copy()
                    else:
                        pad = width - d
                        mp.mean = np.concatenate(
                            [mp.mean, np.zeros(pad, mp.mean.dtype)])
                        mp.var = np.concatenate(
                            [mp.var, np.ones(pad, mp.var.dtype)])
                    mp.fix_gconst()
        widths[s - 1] = width
        hset.stream_widths = widths
        hset.vec_size = sum(widths)
        vf = hset.macros["v"].get("varFloor1")
        if vf is not None and len(vf) != hset.vec_size:
            if len(vf) > hset.vec_size:
                hset.macros["v"]["varFloor1"] = vf[: hset.vec_size].copy()
            else:
                hset.macros["v"]["varFloor1"] = np.concatenate(
                    [vf, np.full(hset.vec_size - len(vf), vf.min(),
                                 vf.dtype)])
        if self.trace:
            print(f"HHEd: SW stream {s} width {old} -> {width} "
                  f"(vecsize {hset.vec_size})")

    def cmd_rc(self, n: int, name: str):
        """RC n name: build an n-terminal regression class tree.

        Mirrors HTK's RegClassesCommand: centroid-split binary tree over
        the set's Gaussians (algo/adapt.build_regression_tree); leaves
        are the base classes and the parent links enable occupancy
        back-off at estimation time. Queues `<name>.cls` for the output
        directory; HERest picks it up via HADAPT: BASECLASS and HVite
        via the MLLRCLASSES TMF chain.
        """
        from ..algo.adapt import build_regression_tree
        from ..models.hmmset import compile_hmmset

        comp = compile_hmmset(self.hset)
        classes, parent, leaf_node = build_regression_tree(comp, n)
        self.baseclasses[f"{name}.cls"] = (name, classes, parent, leaf_node)
        if self.trace:
            import numpy as _np
            sizes = _np.bincount(classes, minlength=len(leaf_node))
            print(f"HHEd: RC {len(leaf_node)} classes / {len(parent)} tree "
                  f"nodes over {len(classes)} Gaussians (sizes {list(sizes)})")

    def cmd_hk(self, kind: str):
        """HK kind: convert the HMM-set kind (HHEd.c SetHMMSetKind).

        PLAINHS/SHAREDHS need no parameter change here (tying is
        identity-based, so both layouts are the same object graph).
        DISCRETEHS converts a continuous set to discrete output
        distributions: each VQ codeword centroid is scored under every
        state's GMM and the scores normalised over the codebook —
        b_j(k) = P(mu_k | state j) / sum_k' P(mu_k' | state j) — the
        HTKBook's continuous->discrete recipe. The codebook (HQuants
        output) comes from config `HHED: VQTABLE`. TIEDHS (TMIX pools)
        is rejected loudly rather than half-converted. [LC]
        """
        import numpy as _np

        from ..io import parmkind as _pk
        from ..io.mmf import MINMIX, StreamElem, logp_to_dprob
        from ..io.vq import load_vq
        from ..utils.logmath import LZERO as _LZ

        kind = kind.upper()
        hs = self.hset
        if kind in ("PLAINHS", "SHAREDHS"):
            hs.hmm_set_id = kind
            return
        if kind == "TIEDHS":
            return self._hk_tiedhs()
        if kind != "DISCRETEHS":
            HError(2640, "HHEd: HK %s conversion unsupported", kind)
        path = (self.cfg.str_("VQTABLE", None, module="HHED")
                if self.cfg else None)
        if not path:
            HError(2640, "HHEd: HK DISCRETEHS needs config HHED: VQTABLE")
        vq = load_vq(path)
        widths = hs.swidth
        if [cb.shape[1] for cb in vq.codebooks] != list(widths):
            HError(2640, "HHEd: HK VQ stream widths %s != set widths %s",
                   [cb.shape[1] for cb in vq.codebooks], widths)

        def logsumexp(a, axis=0):
            hi = _np.max(a, axis=axis, keepdims=True)
            return (hi + _np.log(_np.sum(_np.exp(a - hi), axis=axis,
                                         keepdims=True))).squeeze(axis)

        done = set()
        n_conv = 0
        for h in hs.hmms.values():
            for si in h.states:
                if id(si) in done:
                    continue
                done.add(id(si))
                new_streams = []
                for s, se in enumerate(si.streams):
                    cb = vq.codebooks[s].astype(_np.float64)
                    lps = []
                    for w, mp in zip(se.weights, se.mixes):
                        if mp is None or w < MINMIX:
                            continue
                        d = cb - mp.mean[None].astype(_np.float64)
                        maha = ((d * d) / mp.var[None]).sum(axis=1)
                        lps.append(_np.log(max(w, 1e-30))
                                   - 0.5 * (mp.gconst + maha))
                    if not lps:
                        lp = _np.full(cb.shape[0], _LZ)
                    else:
                        lp = logsumexp(_np.stack(lps), axis=0)
                        lp = lp - logsumexp(lp, axis=0)  # sum_k b(k) = 1
                        # floor at MINMIX then renormalise: 39-dim GMMs
                        # put most codewords below the int16 DPROB range
                        # (e^-13.8), which would decode as hard zeros and
                        # kill every path crossing them (the same floor
                        # discrete reestimation applies)
                        p = _np.maximum(_np.exp(lp), MINMIX)
                        lp = _np.log(p / p.sum())
                    ns = StreamElem()
                    ns.dprobs = logp_to_dprob(lp)
                    new_streams.append(ns)
                si.streams[:] = new_streams
                si.stream_weights = None
                n_conv += 1
        # Gaussian macros are gone with the Gaussians
        for mac in ("m", "u", "v", "i"):
            hs.macros[mac] = {}
        hs.parm_kind = _pk.str2parmkind("DISCRETE")
        hs.vec_size = len(vq.codebooks)
        hs.stream_widths = [1] * len(vq.codebooks)
        hs.hmm_set_id = "DISCRETEHS"
        if self.trace:
            print(f"HHEd: HK DISCRETEHS converted {n_conv} states against "
                  f"{[cb.shape[0] for cb in vq.codebooks]}-word codebooks")

    def _hk_tiedhs(self):
        """HK TIEDHS: continuous -> tied-mixture (HHEd.c SetHMMSetKind).

        Every stream gets ONE shared Gaussian pool (the HTK TMix
        codebook, ~m macros tm{s}_{k}); each state's output becomes a
        weight vector over that pool. The pool is built by k-means over
        the set's own Gaussians (size from config HHED: NUMTIEDMIX,
        default 64) with moment-matched cluster variances, and state
        weights come from scoring each pool mean under the state's
        original GMM, floored at MINMIX and renormalised — the same
        scoring recipe as the DISCRETEHS conversion but keeping a
        continuous shared codebook. [LC vs HHEd.c's exact clustering]
        """
        import numpy as _np

        from ..algo.kmeans import kmeans
        from ..io.mmf import MINMIX, MixPDF, StreamElem

        hs = self.hset
        M = self.jo_size if self.jo_size else (
            int(self.cfg.int_("NUMTIEDMIX", 64, module="HHED") or 64)
            if self.cfg else 64)
        w_floor = self.jo_floor if self.jo_floor is not None else MINMIX

        def logsumexp(a, axis=0):
            hi = _np.max(a, axis=axis, keepdims=True)
            return (hi + _np.log(_np.sum(_np.exp(a - hi), axis=axis,
                                         keepdims=True))).squeeze(axis)

        n_streams = len(hs.swidth)
        pools: list = []
        for s in range(n_streams):
            seen = set()
            gs = []
            for h in hs.hmms.values():
                for si in h.states:
                    se = si.streams[s]
                    if se.dprobs is not None or se.tmix_base:
                        HError(2640, "HHEd: HK TIEDHS needs a continuous "
                                     "source set")
                    for mp in se.mixes:
                        if mp is not None and id(mp) not in seen:
                            seen.add(id(mp))
                            gs.append(mp)
            means = _np.stack([g.mean for g in gs]).astype(_np.float64)
            varp = _np.stack([g.var for g in gs]).astype(_np.float64)
            Ms = min(M, len(gs))
            if Ms == len(gs):
                assign = _np.arange(len(gs))
                cents = means
            else:
                assign, cents = kmeans(means, Ms)
            pool = []
            for k in range(Ms):
                mem = _np.asarray(assign) == k
                if not mem.any():
                    mean_k = cents[k]
                    var_k = varp.mean(axis=0)
                else:
                    mean_k = means[mem].mean(axis=0)
                    # moment matching: E[var + mu^2] - mean_k^2
                    var_k = _np.maximum(
                        (varp[mem] + means[mem] ** 2).mean(axis=0)
                        - mean_k ** 2, 1e-6)
                mp = MixPDF(mean=mean_k.astype(_np.float32),
                            var=var_k.astype(_np.float32))
                mp.fix_gconst()
                pool.append(mp)
            pools.append(pool)

        # score pool means under each state's original GMM
        done = set()
        n_conv = 0
        for h in hs.hmms.values():
            for si in h.states:
                if id(si) in done:
                    continue
                done.add(id(si))
                new_streams = []
                for s, se in enumerate(si.streams):
                    pool = pools[s]
                    probes = _np.stack([p.mean for p in pool]).astype(
                        _np.float64)
                    lps = []
                    for w, mp in zip(se.weights, se.mixes):
                        if mp is None or w < MINMIX:
                            continue
                        d = probes - mp.mean[None].astype(_np.float64)
                        maha = ((d * d) / mp.var[None]).sum(axis=1)
                        lps.append(_np.log(max(w, 1e-30))
                                   - 0.5 * (mp.gconst + maha))
                    lp = logsumexp(_np.stack(lps), axis=0)
                    p = _np.maximum(_np.exp(lp - logsumexp(lp, axis=0)),
                                    w_floor)
                    p = p / p.sum()
                    ns = StreamElem(weights=[float(x) for x in p],
                                    mixes=list(pool),
                                    tmix_base=f"tm{s + 1}_")
                    new_streams.append(ns)
                si.streams[:] = new_streams
                n_conv += 1

        # the pool replaces all per-state Gaussian macros
        for mac in ("m", "u", "v", "i"):
            hs.macros[mac] = {}
        for s, pool in enumerate(pools):
            for k, mp in enumerate(pool):
                hs.macros["m"][f"tm{s + 1}_{k + 1}"] = mp
        hs.hmm_set_id = "TIEDHS"
        if self.trace:
            print(f"HHEd: HK TIEDHS converted {n_conv} states to "
                  f"{[len(p) for p in pools]}-component tied pools")

    def cmd_jo(self, size: int, floor: float):
        """JO size floor: set tied-mixture join parameters (HHEd.c
        JoinOp): the pool size and weight floor used by a subsequent
        HK TIEDHS conversion."""
        self.jo_size = int(size)
        self.jo_floor = float(floor)
        if self.trace:
            print(f"HHEd: JO size={size} floor={floor}")

    def _agglomerate(self, macro: str, spec: str, n: Optional[int],
                     thresh: Optional[float], cmd: str):
        """Shared NC/TC engine (HHEd.c ClusterGroup): agglomerative
        clustering of the item-list states (complete linkage over an
        occupancy-weighted Euclidean distance between the states'
        mixture-weighted mean vectors [LC vs HHEd's exact metric]);
        each cluster is tied to one occupancy-pooled state ~s macroK.

        NC stops at `n` clusters; TC stops when the next merge's
        distance would exceed `thresh`.
        """
        items = parse_item_list(spec, self.hset)
        states = []  # (key(hmm,idx), StateInfo, occ)
        seen = set()
        for it in items:
            si = it.hmm.states[it.state_idx - 2]
            if id(si) in seen:
                continue
            seen.add(id(si))
            occ = self.stats.get((it.hmm.name, it.state_idx), 1.0)
            states.append((it, si, occ))
        if n is not None and len(states) <= n:
            HRError(2640, "HHEd: %s %d over %d states — nothing to do",
                    cmd, n, len(states))
            return
        # feature per state: mixture-weighted mean
        feats = []
        for _it, si, _o in states:
            se = si.streams[0]
            ws = np.asarray([w for w, m in zip(se.weights, se.mixes)
                             if m is not None], np.float64)
            ms = np.stack([m.mean for m in se.mixes if m is not None])
            ws = ws / max(ws.sum(), 1e-30)
            feats.append((ws[:, None] * ms).sum(axis=0))
        feats = np.stack(feats)

        clusters = [[k] for k in range(len(states))]

        def cdist(a, b):  # complete linkage
            return max(np.linalg.norm(feats[i] - feats[j])
                       for i in a for j in b)

        while len(clusters) > (n if n is not None else 1):
            best = None
            for x in range(len(clusters)):
                for y in range(x + 1, len(clusters)):
                    d = cdist(clusters[x], clusters[y])
                    if best is None or d < best[0]:
                        best = (d, x, y)
            _d, x, y = best
            if thresh is not None and _d > thresh:
                break
            clusters[x] = clusters[x] + clusters[y]
            del clusters[y]

        for k, cl in enumerate(sorted(clusters, key=min)):
            members = [(states[i][1], states[i][2]) for i in cl]
            tied = _pooled_state(members)
            name = f"{macro}{k + 1}"
            self.hset.macros["s"][name] = tied
            for i in cl:
                it = states[i][0]
                it.hmm.states[it.state_idx - 2] = tied
        if self.trace:
            print(f"HHEd: {cmd} clustered {len(states)} states into "
                  f"{len(clusters)} tied states ~s {macro}1..")
        return len(clusters)

    def cmd_nc(self, n: int, macro: str, spec: str):
        """NC n macro itemlist: cluster to exactly n tied states."""
        self._agglomerate(macro, spec, n, None, "NC")

    def cmd_tc(self, thresh: float, macro: str, spec: str):
        """TC f macro itemlist: threshold-stopped data-driven clustering
        (HHEd.c TC — the HTKBook's pre-decision-tree tying recipe step):
        merge closest clusters until the next merge distance exceeds f,
        then tie each cluster to a pooled ~s macro.
        """
        self._agglomerate(macro, spec, None, thresh, "TC")

    def cmd_mt(self, list_path: str):
        """MT triList: make triphones from biphones
        (HTKTools/HHEd.c : MakeTriCommand).

        For each triphone l-p+r in the list that is not already in the
        set, clone the left biphone l-p and tie its final emitting
        state to that of the right biphone p+r. [LC: reconstructed —
        the reference mount is empty; semantics follow the HTKBook
        command summary ("make triphones by merging biphones"): the
        left biphone supplies the model body (left context shapes the
        early states), the right biphone the final,
        right-context-sensitive emitting state. The share is
        registered as a ~s macro so it survives MMF round-trips.]
        """
        names = [l for l, p in load_hmm_list(list_path, self.cfg)]
        hset = self.hset
        n_new = 0
        for nm in names:
            if nm in hset.hmms:
                continue
            l, base, r = parse_triphone(nm)
            if l is None or r is None:
                HError(2632, "MT: %s in %s is not a triphone",
                       nm, list_path)
            left = hset.hmms.get(f"{l}-{base}")
            right = hset.hmms.get(f"{base}+{r}")
            if left is None or right is None:
                HError(2662, "MT: missing biphone %s for %s",
                       f"{l}-{base}" if left is None else f"{base}+{r}",
                       nm)
            h = _deep_clone(left, nm)
            mac = f"MT_{base}+{r}"
            shared = hset.macros["s"].get(mac)
            if shared is None:
                shared = right.states[-1]
                hset.macros["s"][mac] = shared
            h.states[-1] = shared
            right.states[-1] = shared
            hset.hmms[nm] = h
            hset.macros["h"][nm] = h
            n_new += 1
        if self.trace:
            print(f"HHEd: MT made {n_new} triphones from biphones "
                  f"in {list_path}")

    def cmd_dp(self, flags: str, ids: List[str]):
        """DP s n id1..idn: duplicate the HMM set once per id.

        Every HMM is cloned under `name + id`; structures whose macro
        type letter appears in `s` (t transitions, s states, m mixtures,
        w stream weights, d durations) get private per-copy objects,
        everything else stays SHARED with the original set — HHEd.c's
        duplicate command for speaker-/condition-dependent modelling.
        The originals remain in the set. [LC: the exact s semantics are
        reconstructed — reference mount empty.]
        """
        import copy as _copy

        hs = self.hset
        dup = set(flags.strip('"'))
        base_hmms = list(hs.hmms.items())  # copies of copies otherwise:
        # later ids would re-clone earlier ids' duplicates
        for did in ids:
            memo: Dict[int, object] = {}

            def _c(obj, typ, did=did, memo=memo):
                if obj is None or typ not in dup:
                    return obj
                got = memo.get(id(obj))
                if got is not None:
                    return got
                if typ == "m":
                    nm = MixPDF(mean=obj.mean.copy(), var=obj.var.copy(),
                                gconst=obj.gconst, cov_kind=obj.cov_kind)
                    out = nm
                elif typ == "t":
                    out = obj.copy()
                else:
                    out = _copy.deepcopy(obj)
                memo[id(obj)] = out
                # duplicated macro definitions get per-copy names
                for mac, table in hs.macros.items():
                    for name, mo in list(table.items()):
                        if mo is obj:
                            table[name + did] = out
                return out

            def _c_state(si, did=did, memo=memo):
                if "s" not in dup and "m" not in dup:
                    return si
                got = memo.get(id(si))
                if got is not None:
                    return got
                ns = StateInfo(
                    streams=[
                        StreamElem(
                            weights=list(se.weights),
                            mixes=[_c(m, "m") for m in se.mixes],
                            dprobs=(se.dprobs.copy()
                                    if se.dprobs is not None else None),
                            tmix_base=se.tmix_base,
                        )
                        for se in si.streams
                    ],
                    stream_weights=(si.stream_weights.copy()
                                    if si.stream_weights is not None
                                    else None),
                    dur=_c(si.dur, "d"),
                )
                memo[id(si)] = ns
                for name, mo in list(hs.macros["s"].items()):
                    if mo is si:
                        hs.macros["s"][name + did] = ns
                return ns

            for name, h in base_hmms:
                nh = HMMDef(
                    name=name + did,
                    nstates=h.nstates,
                    states=[_c_state(si) for si in h.states],
                    transp=_c(h.transp, "t"),
                    dur=_c(h.dur, "d"),
                )
                hs.hmms[nh.name] = nh
                hs.macros["h"][nh.name] = nh
        if self.trace:
            print(f"HHEd: DP duplicated the set {len(ids)}x "
                  f"(ids {' '.join(ids)}, private types "
                  f"'{''.join(sorted(dup))}')")

    def cmd_xf(self, fname: str):
        """XF tmf: associate an input transform with the model set.

        The TMF text embeds in the MMF as the ~a macro (HModel.c
        <INPUTXFORM>); tools run with -k apply it as the base feature/
        model transform. The SAT recipe's final step.
        """
        from ..algo.adapt import load_tmf_text

        try:
            txt = open(fname).read()
        except OSError as e:
            HError(2610, "XF: cannot open transform %s (%s)", fname, e)
        load_tmf_text(txt)  # validate before embedding
        self.hset.input_xform = txt if txt.lstrip().startswith("~a") \
            else '~a "global"\n' + txt
        if self.trace:
            print(f"HHEd: XF attached input transform {fname}")

    def cmd_su(self, widths: List[int]):
        """SU n w1..wn: split the single stream into n streams of the
        given widths (the uneven-split sibling of SS)."""
        hset = self.hset
        if len(hset.swidth) != 1:
            HError(2640, "SU: set already has %d streams",
                   len(hset.swidth))
        if sum(widths) != hset.vec_size:
            HError(2640, "SU: widths sum to %d, vector size is %d",
                   sum(widths), hset.vec_size)
        bounds = np.concatenate([[0], np.cumsum(widths)]).astype(int)
        hset.stream_widths = list(widths)
        done = set()
        for h in hset.hmms.values():
            for si in h.states:
                if id(si) in done:
                    continue
                done.add(id(si))
                src = si.streams[0]
                streams = []
                for s in range(len(widths)):
                    d0, d1 = int(bounds[s]), int(bounds[s + 1])
                    se = StreamElem()
                    for wt, mp in zip(src.weights, src.mixes):
                        if mp is None:
                            se.mixes.append(None)
                            se.weights.append(0.0)
                            continue
                        nmp = MixPDF(mean=mp.mean[d0:d1].copy(),
                                     var=mp.var[d0:d1].copy(),
                                     cov_kind=mp.cov_kind)
                        nmp.fix_gconst()
                        se.mixes.append(nmp)
                        se.weights.append(wt)
                    streams.append(se)
                si.streams = streams
        if self.trace:
            print(f"HHEd: SU split into {len(widths)} streams "
                  f"{widths}")

    def cmd_ps(self, n: int, power: float):
        """PS n p: occupancy-driven mixture allocation — each state's
        stream gets max(1, round(n * occ^p / mean(occ^p))) components
        (split from the heaviest, as MU), so the set averages ~n
        mixtures per state with more where the data is. Needs LS stats.
        [LC: HHEd.c's exact normalisation is reconstructed.]
        """
        if not self.stats:
            HError(2663, "PS: no occupation stats loaded (LS first)")
        occ_p = {}
        for h in self.hset.hmms.values():
            for k in range(len(h.states)):
                occ = self.stats.get((h.name, k + 2))
                if occ is not None:
                    occ_p[(h.name, k + 2)] = max(occ, 1e-8) ** power
        if not occ_p:
            HError(2663, "PS: stats match no loaded HMM")
        mean_p = float(np.mean(list(occ_p.values())))
        done = set()
        n_split = 0
        for h in self.hset.hmms.values():
            for k, si in enumerate(h.states):
                key = (h.name, k + 2)
                if key not in occ_p:
                    continue
                tgt = max(1, int(round(n * occ_p[key] / mean_p)))
                for se in si.streams:
                    if id(se) in done or se.dprobs is not None:
                        continue
                    done.add(id(se))
                    cur = len([m for m in se.mixes if m is not None])
                    while cur < tgt:
                        _split_heaviest(se)
                        cur += 1
                        n_split += 1
        if self.trace:
            print(f"HHEd: PS n={n} p={power}: {n_split} splits")

    def cmd_ut(self, spec: str):
        """UT itemlist: untie — every shared state in the list becomes a
        private deep copy (HHEd.c UntieCmd for state items)."""
        from ..io.mmf import StateInfo as _SI

        items = parse_item_list(spec, self.hset)
        counts: Dict[int, int] = {}
        for it in items:
            si = it.hmm.states[it.state_idx - 2]
            counts[id(si)] = counts.get(id(si), 0) + 1
        n_untied = 0
        shared_names = {id(o): nm
                        for nm, o in self.hset.macros["s"].items()}
        for it in items:
            si = it.hmm.states[it.state_idx - 2]
            se = si.streams[0]
            copy = _SI(streams=[StreamElem(
                weights=list(se.weights),
                mixes=[None if m is None else MixPDF(
                    mean=np.array(m.mean, np.float32).copy(),
                    var=np.array(m.var, np.float32).copy(),
                    gconst=m.gconst, cov_kind=m.cov_kind)
                    for m in se.mixes])])
            it.hmm.states[it.state_idx - 2] = copy
            n_untied += 1
        # macros whose object is no longer referenced anywhere drop away
        live = {id(si) for h in self.hset.hmms.values() for si in h.states}
        for oid, nm in shared_names.items():
            if oid not in live:
                del self.hset.macros["s"][nm]
        if self.trace:
            print(f"HHEd: UT untied {n_untied} states")

    def cmd_fv(self, path: str):
        """FV file: load variance-floor macros (HCompV vFloors output)
        and apply them to every variance (HHEd.c FloorVars)."""
        from ..io.mmf import load_mmf as _load

        vf_set = _load(path)
        floor = vf_set.macros["v"].get("varFloor1")
        if floor is None:
            HError(2640, "HHEd: FV %s has no varFloor1 macro", path)
        self.hset.macros["v"]["varFloor1"] = floor
        n_fl = 0
        done = set()
        for h in self.hset.hmms.values():
            for si in h.states:
                for se in si.streams:
                    for mp in se.mixes or []:
                        if mp is None or id(mp) in done:
                            continue
                        done.add(id(mp))
                        lo = np.asarray(floor, np.float32)[: len(mp.var)]
                        v = np.maximum(mp.var, lo)
                        if not np.array_equal(v, mp.var):
                            n_fl += 1
                        mp.var = v.astype(np.float32)
                        mp.fix_gconst()
        if self.trace:
            print(f"HHEd: FV floored {n_fl} variance vectors")

    def cmd_rn(self, new_id: str):
        """RN id: rename the HMM-set identifier (HHEd.c RenameHMMSetId)."""
        self.hset.hmm_set_id = new_id
        if self.trace:
            print(f"HHEd: RN hmmSetId = {new_id}")

    def cmd_fc(self):
        """FC: convert every diagonal Gaussian to full covariance
        (HHEd.c FullCovarCommand). The new <INVCOVAR> is diag(1/var),
        so likelihoods are unchanged until reestimation learns the
        off-diagonals (HERest's dedicated FULLC path)."""
        n = 0
        done = set()
        for h in self.hset.hmms.values():
            for si in h.states:
                for se in si.streams:
                    for mp in se.mixes or []:
                        if mp is None or id(mp) in done:
                            continue
                        done.add(id(mp))
                        if mp.cov_kind != "DIAGC":
                            continue
                        mp.var = np.diag(
                            1.0 / np.asarray(mp.var, np.float64)
                        ).astype(np.float32)
                        mp.cov_kind = "FULLC"
                        mp.fix_gconst()
                        n += 1
        self.hset.cov_kind = "FULLC"
        if self.trace:
            print(f"HHEd: FC converted {n} Gaussians to FULLC")

    def cmd_sk(self, kind: str):
        """SK kind: set the sample kind of the set (HHEd.c
        SetSampKindCommand) — used when the feature pipeline changes
        without touching the parameters."""
        from ..io.parmkind import str2parmkind

        self.hset.parm_kind = int(str2parmkind(kind))
        if self.trace:
            print(f"HHEd: SK parmKind = {kind}")

    def cmd_fa(self, frac: float):
        """FA f: variance floor := f * average per-dim variance over the
        set's Gaussians (HHEd.c FloorAverageCommand), stored as the
        varFloor1 macro and applied immediately. The average is
        occupancy-weighted when LS stats are loaded, plain otherwise
        [LC — the reference's exact weighting is unverified]."""
        num = None
        den = 0.0
        for h in self.hset.hmms.values():
            for q, si in enumerate(h.states):
                occ = (self.stats.get((h.name, q + 2), 1.0)
                       if self.stats else 1.0)
                for se in si.streams:
                    for w, mp in zip(se.weights, se.mixes or []):
                        if mp is None or mp.cov_kind != "DIAGC":
                            continue
                        wt = occ * float(w)
                        v = np.asarray(mp.var, np.float64) * wt
                        num = v if num is None else num + v
                        den += wt
        if num is None or den <= 0:
            HError(2640, "FA: no diagonal Gaussians to average")
        floor = (frac * num / den).astype(np.float32)
        self.hset.macros.setdefault("v", {})["varFloor1"] = floor
        n_fl = 0
        done = set()
        for h in self.hset.hmms.values():
            for si in h.states:
                for se in si.streams:
                    for mp in se.mixes or []:
                        if mp is None or id(mp) in done \
                                or mp.cov_kind != "DIAGC":
                            continue
                        done.add(id(mp))
                        v = np.maximum(mp.var, floor[: len(mp.var)])
                        if not np.array_equal(v, mp.var):
                            n_fl += 1
                        mp.var = v.astype(np.float32)
                        mp.fix_gconst()
        if self.trace:
            print(f"HHEd: FA floor = {frac} * avg var, "
                  f"floored {n_fl} variance vectors")

    def cmd_mm(self, macro: str, spec: str):
        """MM macro itemlist: make each item into a macro named
        macro<N> (HHEd.c MakeIntoMacrosCommand) so a later save writes
        them as shared ~s/~t/~m definitions."""
        items = parse_item_list(spec, self.hset)
        kind = items[0].kind
        code = {"state": "s", "transP": "t", "mix": "m"}.get(kind)
        if code is None:
            HError(2640, "MM: unsupported item kind %s "
                         "(state/transP/mix)", kind)
        tab = self.hset.macros.setdefault(code, {})
        for i, it in enumerate(items):
            if kind == "state":
                obj = it.hmm.states[it.state_idx - 2]
            elif kind == "transP":
                obj = it.hmm.transp
            else:
                obj = _get_mix(it)
            tab[f"{macro}{i + 1}"] = obj
        if self.trace:
            print(f"HHEd: MM made {len(items)} ~{code} macros '{macro}*'")

    def cmd_st(self, path: str):
        save_trees(path, self.questions, self.trees)
        if self.trace:
            print(f"HHEd: ST saved {len(self.trees)} trees to {path}")

    def cmd_lt(self, path: str):
        qd, trees = load_trees(path)
        self.qdict.update(qd)
        self.questions.extend(q for q in qd.values() if q not in self.questions)
        self.trees.extend(trees)
        if self.trace:
            print(f"HHEd: LT loaded {len(trees)} trees from {path}")

    def cmd_sh(self):
        hs = self.hset
        n_states = len({id(s) for h in hs.hmms.values() for s in h.states})
        print(
            f"HMMSet: {len(hs.hmms)} models, {n_states} physical states, "
            f"{len(hs.macros['s'])} ~s macros, vecsize {hs.vec_size}"
        )


def _deep_clone(src: HMMDef, name: str) -> HMMDef:
    h = HMMDef(name=name, nstates=src.nstates)
    for si in src.states:
        se_src = si.streams[0]
        se = StreamElem()
        for w, mp in zip(se_src.weights, se_src.mixes):
            if mp is None:
                se.mixes.append(None)
                se.weights.append(0.0)
                continue
            nmp = MixPDF(
                mean=np.array(mp.mean, np.float32).copy(),
                var=np.array(mp.var, np.float32).copy(),
                cov_kind=mp.cov_kind,
                gconst=mp.gconst,
            )
            se.mixes.append(nmp)
            se.weights.append(w)
        h.states.append(StateInfo(streams=[se]))
    h.transp = np.array(src.transp, np.float32).copy()
    return h


def _get_mix(it: Item) -> MixPDF:
    si = it.hmm.states[it.state_idx - 2]
    return si.streams[it.stream_idx - 1].mixes[(it.mix_idx or 1) - 1]


def _pooled_state(members: List[Tuple[StateInfo, float]]) -> StateInfo:
    """Occupancy-pooled single-Gaussian tied state for a TB leaf."""
    occ = sum(o for _, o in members) or 1.0
    d = len(members[0][0].streams[0].mixes[0].mean)
    mean = np.zeros(d, np.float64)
    sqr = np.zeros(d, np.float64)
    for si, o in members:
        mp = si.streams[0].mixes[0]
        mean += o * mp.mean.astype(np.float64)
        sqr += o * (mp.var.astype(np.float64) + mp.mean.astype(np.float64) ** 2)
    mean /= occ
    var = np.maximum(sqr / occ - mean * mean, 1e-6)
    mp = MixPDF(mean=mean.astype(np.float32), var=var.astype(np.float32))
    mp.fix_gconst()
    se = StreamElem(weights=[1.0], mixes=[mp])
    return StateInfo(streams=[se])


def _split_heaviest(se: StreamElem):
    """HHEd MU: clone the heaviest mixture, perturb means +/-0.2 stddev."""
    live = [(i, w) for i, (w, m) in enumerate(zip(se.weights, se.mixes))
            if m is not None]
    if not live:
        return
    i, w = max(live, key=lambda t: t[1])
    mp = se.mixes[i]
    sd = np.sqrt(np.maximum(mp.var.astype(np.float64), 1e-10)).astype(np.float32)
    new = MixPDF(
        mean=(mp.mean + 0.2 * sd).astype(np.float32),
        var=mp.var.copy(),
        cov_kind=mp.cov_kind,
    )
    new.fix_gconst()
    mp.mean = (mp.mean - 0.2 * sd).astype(np.float32)
    mp.fix_gconst()
    se.weights[i] = w / 2.0
    se.mixes.append(new)
    se.weights.append(w / 2.0)


# -- script parsing ---------------------------------------------------------


class _ScriptReader:
    """Sequential token reader for HHEd scripts.

    Tokens: quoted strings ('..' or ".."), brace groups ({..} returned
    whole, with nesting), bare words. Comments run from // to end of line.
    """

    def __init__(self, text: str):
        text = re.sub(r"//[^\n]*", " ", text)
        self.text = text
        self.pos = 0

    def _skip_ws(self):
        while self.pos < len(self.text) and self.text[self.pos].isspace():
            self.pos += 1

    def next(self) -> Optional[str]:
        self._skip_ws()
        if self.pos >= len(self.text):
            return None
        c = self.text[self.pos]
        if c in "'\"":
            end = self.text.index(c, self.pos + 1)
            tok = self.text[self.pos + 1 : end]
            self.pos = end + 1
            return tok
        if c == "{":
            depth = 0
            start = self.pos
            while self.pos < len(self.text):
                if self.text[self.pos] == "{":
                    depth += 1
                elif self.text[self.pos] == "}":
                    depth -= 1
                    if depth == 0:
                        self.pos += 1
                        return self.text[start : self.pos]
                self.pos += 1
            HError(2619, "HHEd: unterminated { in script")
        m = re.match(r"\S+", self.text[self.pos :])
        tok = m.group(0)
        self.pos += len(tok)
        return tok


def run_script(text: str, ed: Editor):
    r = _ScriptReader(text)
    while True:
        op = r.next()
        if op is None:
            return
        if op == "TR":
            ed.trace = int(r.next())
        elif op == "QS":
            name = r.next()
            pats_tok = r.next()
            pats = [p.strip().strip('"') for p in pats_tok.strip("{}").split(",")
                    if p.strip()]
            ed.cmd_qs(name, pats)
        elif op == "RO":
            thresh = float(r.next())
            # optional stats file: peek — next token is a path unless it
            # is another command (2 uppercase letters) or brace
            save = r.pos
            nxt = r.next()
            if nxt is not None and not re.fullmatch(r"[A-Z]{2}", nxt):
                ed.cmd_ro(thresh, nxt)
            else:
                r.pos = save
                ed.cmd_ro(thresh, None)
        elif op == "LS":
            ed.cmd_ls(r.next())
        elif op == "CL":
            ed.cmd_cl(r.next())
        elif op == "TI":
            macro = r.next()
            ed.cmd_ti(macro, r.next())
        elif op == "TB":
            thresh = float(r.next())
            macro = r.next()
            ed.cmd_tb(thresh, macro, r.next())
        elif op == "AU":
            ed.cmd_au(r.next())
        elif op == "ST":
            ed.cmd_st(r.next())
        elif op == "LT":
            ed.cmd_lt(r.next())
        elif op == "MU":
            ed.cmd_mu(r.next(), r.next())
        elif op == "AT":
            i, j, p = int(r.next()), int(r.next()), float(r.next())
            ed.cmd_at(i, j, p, r.next())
        elif op == "RT":
            i, j = int(r.next()), int(r.next())
            ed.cmd_rt(i, j, r.next())
        elif op == "SH":
            ed.cmd_sh()
        elif op == "CO":
            ed.cmd_co(r.next())
        elif op == "MD":
            ed.cmd_md(int(r.next()), r.next())
        elif op == "HK":
            ed.cmd_hk(r.next())
        elif op == "SS":
            ed.cmd_ss(int(r.next()))
        elif op == "SW":
            ed.cmd_sw(int(r.next()), int(r.next()))
        elif op == "RC":
            ed.cmd_rc(int(r.next()), r.next().strip('"'))
        elif op == "JO":
            ed.cmd_jo(int(r.next()), float(r.next()))
        elif op == "NC":
            n = int(r.next())
            macro = r.next()
            ed.cmd_nc(n, macro, r.next())
        elif op == "TC":
            ed.cmd_tc(float(r.next()), r.next(), r.next())
        elif op == "MT":
            ed.cmd_mt(r.next())
        elif op == "DP":
            flags = r.next()
            nn = int(r.next())
            ed.cmd_dp(flags, [r.next() for _ in range(nn)])
        elif op == "XF":
            ed.cmd_xf(r.next())
        elif op == "SU":
            nn = int(r.next())
            ed.cmd_su([int(r.next()) for _ in range(nn)])
        elif op == "PS":
            ed.cmd_ps(int(r.next()), float(r.next()))
        elif op == "UT":
            ed.cmd_ut(r.next())
        elif op == "FV":
            ed.cmd_fv(r.next())
        elif op == "RN":
            ed.cmd_rn(r.next())
        elif op == "FC":
            ed.cmd_fc()
        elif op == "SK":
            ed.cmd_sk(r.next())
        elif op == "FA":
            ed.cmd_fa(float(r.next()))
        elif op == "MM":
            macro = r.next()
            ed.cmd_mm(macro, r.next())
        else:
            HError(2650, "HHEd: unknown command %s", op)


def run(argv: List[str]) -> int:
    ta = parse_args("HHEd", argv, OPTS, min_args=2, usage=USAGE)
    script_file, hmm_list_file = ta.args[0], ta.args[1]
    mmfs = ta.get_all("H")
    if not mmfs:
        HError(1030, "HHEd: at least one -H mmf required\n%s", USAGE)
    hset = load_mmf(mmfs, cfg=ta.config)
    load_hmm_list(hmm_list_file, ta.config)

    ed = Editor(hset, trace=ta.trace, cfg=ta.config)
    run_script(open(script_file).read(), ed)

    out_dir = ta.get("M", ".")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, os.path.basename(mmfs[0]))
    save_mmf(hset, out, binary=ta.binary)
    if ed.baseclasses:
        from ..algo.adapt import save_baseclass

        for fname, (macro, classes, parent, leaf_node) in \
                ed.baseclasses.items():
            save_baseclass(os.path.join(out_dir, fname), macro, classes,
                           parent=parent, leaf_node=leaf_node)
            if ta.trace:
                print(f"HHEd: wrote {os.path.join(out_dir, fname)}")
    if ta.has("w"):
        with open(ta.get("w"), "w") as f:
            for nm in hset.hmms:
                f.write(nm + "\n")
    if ta.trace:
        print(f"HHEd: saved {out}")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
