"""HMMIRest — MMI discriminative training (lattice-based EBW), in torch.

The PyTorch counterpart of `htk_tpu/tools/hmmirest.py`
(`HTKTools/HMMIRest.c`): numerator (reference) and denominator
(recognition-lattice) occupancies accumulate separately, then Extended
Baum-Welch updates the Gaussians (algo/ebw.py, host numpy).

Lattice forward-backward (the HArc/HFBLat role): every word arc of a
lattice becomes a mini-utterance (its pronunciation's phone chain over its
time span). Arcs batch through the HFB scans kernel (ops/fb_scans, the
hand-written CUDA kernel on the card): one launch a bucket scores them
(its logP), a host DAG forward-backward turns the per-arc
log-likelihoods into arc posteriors, and a second weighted pass
(algo/fb.fb_batch) accumulates gamma-scaled statistics. Exact for
HVite-style time-marked lattices.

Deviation from HTK (as htk_tpu): lattices are *word* lattices (HVite -z
output) plus a dictionary (-d), instead of HTK's phone-marked lattices;
the phone-level information is recovered by per-arc alignment on the fly.

Usage: python -m htk_tpu_torch.tools.hmmirest [options] hmmList trainFiles...

  -H mmf   load HMM macro file (repeatable)   -M dir  output directory
  -q dir   numerator lattice dir (else -I MLF transcriptions are used)
  -r dir   denominator lattice dir (required)
  -d dict  dictionary for word->phone expansion
  -I mlf   numerator transcriptions (phone level, as HERest)
  -s f     LM scale for lattice posteriors (default 1.0)
  -u tmvw  update flags (accepted; EBW updates m,v,w)
  Config (HMMIREST module): DISCRMODE (MMI | MPE | MWE), E (default 2.0),
  ISMOOTHTAU (default 0), MINVAR, LATPROBSCALE (default 1.0), ACCBLOCK
  (utterances a block, default 8), ARCBATCH (arcs a launch at 32 frames,
  default 256); HTKTPU: PRECISION
  Standard: -A -C -D -S -T -V

-T 1 prints the occupancies, the MMI criterion (MMI mode), the lattice
arcs, the unique arc mini-utterances and the score and accumulate
launches. The device is the CUDA card, or the CPU when
HTK_TPU_TORCH_DEVICE=cpu asks for it (tools/_common.py). FULLC and
DISCRETE sets are refused with HError 2390, as HERest refuses them.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple

import numpy as np
import torch

from ..algo.composite import build_composite
from ..algo.ebw import EBWConfig, ebw_update
from ..algo.fb import Accumulators, _fb_outp, fb_batch, zero_accs
from ..algo.latops import arc_mpe_weights, arc_posteriors
from ..algo.net import word_internal_phone_map
from ..algo.trainer import Trainer, prepare_utterance
from ..io.dictionary import read_dict
from ..io.mlf import MLF, find_labels
from ..io.mmf import load_hmm_list, load_mmf, save_mmf
from ..io.slf import NULL_WORD, read_slf
from ..models.hmmset import compile_hmmset, write_back
from ..ops.fb_scans import fb_scans
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, HRError
from ..utils.logmath import LZERO
from ._common import default_device, open_speech_file, outp_precision

USAGE = ("Usage: python -m htk_tpu_torch.tools.hmmirest [options] hmmList "
         "trainFiles...")

OPTS = {
    "H": Option("H", 1, "load MMF", repeatable=True),
    "M": Option("M", 1, "output directory"),
    "q": Option("q", 1, "numerator lattice dir"),
    "r": Option("r", 1, "denominator lattice dir"),
    "d": Option("d", 1, "dictionary"),
    "I": Option("I", 1, "numerator MLF", repeatable=True),
    "L": Option("L", 1, "label dir"),
    "X": Option("X", 1, "label ext"),
    "s": Option("s", 1, "LM scale", typ=float),
    "u": Option("u", 1, "update flags"),
}


class ArcUtt(NamedTuple):
    """One unique arc mini-utterance, by reference into the block's
    feature bank."""

    name: str
    utt: int  # index into the current block's feature bank
    t0: int
    t1: int
    ids: tuple  # phone-id tuple (composite registry key)


def lattice_arc_utts(lat, vocab, comp, feats, period, stem, arcfb, utt=0):
    """Word arcs -> (unique ArcUtt list, {arc id: utt name}).

    Arcs sharing (pronunciation, start frame, end frame) collapse to ONE
    mini-utterance (the `HArc.c` arc-sharing role): identical FB
    problems score identically, and their posterior weights sum linearly
    into the accumulators. Composites register with `arcfb`."""
    words_of = {n.id: n.word for n in lat.nodes}
    times_of = {n.id: n.time for n in lat.nodes}
    utts = []
    arc2name = {}
    seen = {}
    T = feats.shape[0]
    for a in lat.arcs:
        w = a.word if a.word is not None else words_of.get(a.end)
        if not w or w == NULL_WORD:
            continue
        t0 = int(round(times_of[a.start] * 1e7 / period))
        t1 = int(round(times_of[a.end] * 1e7 / period))
        t0 = max(0, min(t0, T - 1))
        t1 = max(t0 + 1, min(t1, T))
        wd = vocab.get(w)
        if wd is None:
            HRError(8621, "HMMIRest: word %s not in dictionary", w)
            continue
        # word-internal context expansion (HNet.c FindModel order): on a
        # triphone set, raw monophone prons would score stale monophone
        # models
        phones = arcfb.phone_map(wd.prons[0].phones)
        try:
            ids = tuple(comp.model_id(p) for p in phones)
        except Exception:
            continue
        hmm = arcfb.composite(ids)
        if hmm is None:
            continue
        if t1 - t0 < hmm.n_states // max(len(phones), 1):
            t1 = min(T, t0 + max(hmm.n_states, 1))
        key = (ids, t0, t1)
        nm = seen.get(key)
        if nm is None:
            nm = f"{stem}:{a.id}"
            seen[key] = nm
            utts.append(ArcUtt(name=nm, utt=utt, t0=t0, t1=t1, ids=ids))
        arc2name[a.id] = nm
    return utts, arc2name


def _bucket(n: int, base: int = 32) -> int:
    b = base
    while b < n:
        b = b * 2 if b < 512 else b + 256
    return b


class ArcFB:
    """Device-resident arc scoring and accumulation (the `HFBLat.c :
    DoFBLat` role).

    The block's feature matrices go to the device once as a (U, Tmax +
    pad, D) bank; every distinct composite goes once into a per-Q-bucket
    bank of device tensors, rebuilt only when new composites joined it.
    Arcs bucket by padded (T, Q) and launch `batch * 32 / Tb` wide; a
    launch ships four index vectors (utterance, start frame, frame count,
    composite) and gathers its frames from the bank with one advanced
    index. Rows past the bucket's arcs pad with composite 0 and t_real =
    0: `fb_batch` drops them, and the score pass never reads their logP.
    OutP scores only the Gaussians each arc touches (`gather_outp`).
    `launches` counts the score and accumulate launches.
    """

    def __init__(self, trainer, comp, batch: int = 1024):
        self.trainer = trainer
        self.comp = comp
        self.batch = int(batch)
        self.device = trainer.device
        self.phone_map = word_internal_phone_map(comp.names)
        self.composite_cache: dict = {}  # ids -> CompositeHMM
        self._members: dict = {}  # qb -> [ids] in bank order
        self._comp_idx: dict = {}  # ids -> (qb, index)
        self._banks: dict = {}  # qb -> dict of device tensors
        self._dirty: set = set()
        self._params = trainer.params()
        self.launches = {"score": 0, "accumulate": 0}

    # -- composite registry / device banks --------------------------------
    def composite(self, ids):
        hmm = self.composite_cache.get(ids)
        if hmm is None:
            try:
                hmm = build_composite(self.comp, list(ids))
            except Exception:
                return None
            self.composite_cache[ids] = hmm
            qb = _bucket(hmm.n_states, 16)
            mem = self._members.setdefault(qb, [])
            self._comp_idx[ids] = (qb, len(mem))
            mem.append(ids)
            self._dirty.add(qb)
        return hmm

    def _bank(self, qb):
        if qb in self._dirty or qb not in self._banks:
            mem = self._members[qb]
            N = len(mem)
            S = self.comp.n_states
            arrs = dict(
                comp_state=np.full((N, qb), S, np.int32),
                q_mask=np.zeros((N, qb), bool),
                logA=np.full((N, qb, qb), LZERO, np.float32),
                a0=np.full((N, qb), LZERO, np.float32),
                aE=np.full((N, qb), LZERO, np.float32),
                tr_seg=np.full((N, qb, qb), -1, np.int32),
                entry_seg=np.full((N, qb), -1, np.int32),
                exit_seg=np.full((N, qb), -1, np.int32))
            for i, ids in enumerate(mem):
                h = self.composite_cache[ids]
                q = h.n_states
                arrs["comp_state"][i, :q] = np.minimum(h.comp_state, S)
                arrs["q_mask"][i, :q] = True
                arrs["logA"][i, :q, :q] = h.logA
                arrs["a0"][i, :q] = h.a0
                arrs["aE"][i, :q] = h.aE
                arrs["tr_seg"][i, :q, :q] = h.tr_seg
                arrs["entry_seg"][i, :q] = h.entry_seg
                arrs["exit_seg"][i, :q] = h.exit_seg
            self._banks[qb] = {k: torch.as_tensor(v, device=self.device)
                               for k, v in arrs.items()}
            self._dirty.discard(qb)
        return self._banks[qb]

    def load_block(self, feats_list):
        """A block's feature matrices as one padded device bank, with
        `pad = bucket(Tmax)` zero frames at the end so every (t0, t0 + Tb)
        window is in bounds."""
        U = len(feats_list)
        D = self.comp.dim
        Tmax = max(int(f.shape[0]) for f in feats_list)
        bank = np.zeros((U, Tmax + _bucket(Tmax), D), np.float32)
        for u, f in enumerate(feats_list):
            bank[u, : f.shape[0]] = f
        return torch.as_tensor(bank, device=self.device)

    # -- launches -----------------------------------------------------------
    def _buckets(self, utts):
        """Group ArcUtts by (Tb, Qb); width scales down with Tb so the
        per-launch activation footprint stays roughly constant."""
        groups: dict = {}
        for u in utts:
            qb, _i = self._comp_idx[u.ids]
            tb = _bucket(u.t1 - u.t0)
            groups.setdefault((tb, qb), []).append(u)
        out = []
        for (tb, qb), us in sorted(groups.items()):
            bw = max(32, (self.batch * 32) // tb)
            for i0 in range(0, len(us), bw):
                out.append((tb, qb, bw, us[i0:i0 + bw]))
        return out

    def _operands(self, fbank, cbank, batch, bw, tb):
        """A launch's device operands: frames (bw, Tb, D) gathered from
        the bank, t_real (bw,) int32 (0 on padding rows) and the
        composites' tensors for each row (composite 0 on padding)."""
        idx = np.zeros((4, bw), np.int64)  # utt, t0, t_real, composite
        for i, u in enumerate(batch):
            idx[:, i] = (u.utt, u.t0, u.t1 - u.t0, self._comp_idx[u.ids][1])
        utt, t0, t_real, cidx = torch.as_tensor(idx, device=self.device)
        frames = t0[:, None] + torch.arange(tb, device=self.device)[None]
        feats = fbank[utt[:, None], frames]
        comp = {k: v[cidx] for k, v in cbank.items()}
        return feats, t_real.to(torch.int32), comp

    def score(self, fbank, utts) -> dict:
        """Batched per-arc acoustic log-likelihoods: {utt name: ll}, each
        bucket's from one fb_scans launch (the forward scan's logP)."""
        p = self._params
        blocks = tuple(self.comp.slot_blocks) or None
        prec = self.trainer.precision
        pending = []
        for tb, qb, bw, batch in self._buckets(utts):
            feats, t_real, c = self._operands(fbank, self._bank(qb), batch,
                                              bw, tb)
            outp, _g, _bs = _fb_outp(
                feats, c["comp_state"], c["q_mask"], means=p["means"],
                variances=p["variances"], gconsts=p["gconsts"],
                state_mix=p["state_mix"], state_logw=p["state_logw"],
                state_sw=p["state_sw"], slot_blocks=blocks, precision=prec,
                gather_outp=True)
            _a, _b, logp, _xi = fb_scans(outp, c["logA"], c["a0"], c["aE"],
                                         t_real)
            self.launches["score"] += 1
            # materialise after every launch is queued
            pending.append((batch, logp))
        arc_ll = {}
        for batch, logp in pending:
            for u, ll in zip(batch, logp.cpu().numpy()[: len(batch)]):
                arc_ll[u.name] = float(ll)
        return arc_ll

    def accumulate(self, fbank, utts, weights_by_name, total):
        """Weight-scaled FB accumulation over arc mini-utterances, added
        into `total` in place and returned. `weights_by_name[u.name]`
        carries each mini-utterance's summed arc-posterior weight."""
        p = self._params
        blocks = tuple(self.comp.slot_blocks) or None
        for tb, qb, bw, batch in self._buckets(utts):
            weights = np.zeros(bw, np.float32)
            for i, u in enumerate(batch):
                weights[i] = float(weights_by_name.get(u.name, 0.0))
            if not (weights > 0).any():
                continue
            feats, t_real, c = self._operands(fbank, self._bank(qb), batch,
                                              bw, tb)
            _lp, accs = fb_batch(
                feats, t_real, c["comp_state"], c["q_mask"], c["logA"],
                c["a0"], c["aE"], c["tr_seg"], c["entry_seg"],
                c["exit_seg"], torch.as_tensor(weights, device=self.device),
                **p, slot_blocks=blocks, n_states=self.comp.n_states,
                tr_flat=self.trainer.tr_flat,
                precision=self.trainer.precision, gather_outp=True)
            self.launches["accumulate"] += 1
            for a, b in zip(total, accs):
                a.add_(b)
        return total


def accumulate_lattice(lat, vocab, comp, trainer, feats, period, stem,
                       lm_scale, total, arcfb=None):
    """MMI denominator: arc-posterior-weighted accumulation (HFBLat role)."""
    if arcfb is None:
        arcfb = ArcFB(trainer, comp)
    fbank = arcfb.load_block([feats])
    utts, arc2name = lattice_arc_utts(lat, vocab, comp, feats, period, stem,
                                      arcfb, utt=0)
    if not utts:
        return total, 0.0
    arc_ll = arcfb.score(fbank, utts)
    for a in lat.arcs:
        nm = arc2name.get(a.id)
        if nm is not None:
            a.aclike = arc_ll[nm]
    logp, post = arc_posteriors(lat, lmscale=lm_scale, wdpenalty=0.0)
    wname: dict = {}
    for aid, g in post.items():
        nm = arc2name.get(aid)
        if nm is not None and g > -30:
            wname[nm] = wname.get(nm, 0.0) + float(np.exp(min(g, 0.0)))
    total = arcfb.accumulate(fbank, utts, wname, total)
    return total, logp


def _host(accs) -> Accumulators:
    """Accumulators as host numpy arrays, the form ebw_update reads."""
    return Accumulators(*(a.cpu().numpy() for a in accs))


def _not_ported(what: str):
    HError(2390, "HMMIRest: %s is not yet ported to htk_tpu_torch", what)


def run(argv: List[str]) -> int:
    ta = parse_args("HMMIRest", argv, OPTS, min_args=1, usage=USAGE)
    cfg = ta.config
    hmm_list_file = ta.args[0]
    files = ta.script + ta.args[1:]
    if not files:
        HError(1030, "HMMIRest: no training files\n%s", USAGE)
    mmfs = ta.get_all("H")
    if not mmfs:
        HError(1030, "HMMIRest: at least one -H mmf required")
    if not ta.has("r"):
        HError(1030, "HMMIRest: denominator lattice dir (-r) required")

    hset = load_mmf(mmfs, cfg=ta.config)
    load_hmm_list(hmm_list_file, ta.config)
    comp = compile_hmmset(hset)
    if comp.full_cov:
        _not_ported("training a FULLC set")
    if comp.discrete:
        _not_ported("training a DISCRETE set")
    vocab = read_dict(ta.get("d"), ta.config) if ta.has("d") else None
    mlfs = [MLF.load(p, ta.config) for p in ta.get_all("I")]
    lm_scale = float(ta.get("s", 1.0) or 1.0)
    device = default_device()
    if ta.trace:
        print(f"HMMIRest: device {device}")

    ecfg = EBWConfig(
        e=cfg.flt_("E", 2.0, module="HMMIREST"),
        tau_i=cfg.flt_("ISMOOTHTAU", 0.0, module="HMMIREST"),
        min_var=cfg.flt_("MINVAR", 1e-6, module="HMMIREST"),
    )
    # LATPROBSCALE (HFBLat.c probScale, typically 1/grammar-scale):
    # scales the whole lattice score exponent before posteriors, so the
    # denominator's occupancy mass spreads over competitors
    kappa = cfg.flt_("LATPROBSCALE", 1.0, module="HMMIREST")

    trainer = Trainer(comp, precision=outp_precision(cfg), device=device)
    num_total = zero_accs(comp.n_mix, comp.dim, comp.n_states, comp.max_mix,
                          trainer.tr_flat, device=device)
    den_total = zero_accs(comp.n_mix, comp.dim, comp.n_states, comp.max_mix,
                          trainer.tr_flat, device=device)

    mode = (cfg.str_("DISCRMODE", "MMI", module="HMMIREST") or "MMI").upper()
    period = int(cfg.flt_("TARGETRATE", 100000.0, module="HPARM"))
    total_acc_exp = 0.0
    null_words = (set() if vocab is None else {
        w.name for w in vocab.words.values() if w.prons[0].out_sym == ""})

    # Utterances accumulate in blocks of ACCBLOCK: the arc mini-utterances
    # of every lattice in the block share one length-bucketed scoring
    # pass and one accumulation pass; per-lattice posterior math is
    # unchanged. ARCBATCH sets the padded width of an arc launch.
    acc_block = int(cfg.int_("ACCBLOCK", 8, module="HMMIREST") or 8)
    arc_batch = int(cfg.int_("ARCBATCH", 256, module="HMMIREST") or 256)
    arcfb = ArcFB(trainer, comp, batch=arc_batch)
    pend: List[dict] = []
    # per-side lattice total logP under the current model: the MMI
    # criterion's num - den delta across iterations
    lat_lp = {"num_lat": 0.0, "den_lat": 0.0}
    n_arcs = [0, 0]  # lattice arcs, unique arc mini-utterances

    def flush():
        nonlocal total_acc_exp
        if not pend:
            return
        # 1) the block's feature bank; every lattice expanded (the host
        # builds index tuples only); role tags keep numerator and
        # denominator arc names distinct per utterance
        fbank = arcfb.load_block([it["data"] for it in pend])
        jobs = []
        all_utts = []
        for ui, it in enumerate(pend):
            for role, tag in (("num_lat", "#n"), ("den_lat", "#d")):
                lat = it.get(role)
                if lat is None:
                    continue
                utts, a2n = lattice_arc_utts(
                    lat, vocab, comp, it["data"], period, it["stem"] + tag,
                    arcfb, utt=ui)
                n_arcs[0] += len(a2n)
                n_arcs[1] += len(utts)
                if not utts:
                    continue
                jobs.append((role, lat, utts, a2n, it))
                all_utts.extend(utts)
        # 2) one blocked scoring pass for every arc in the block
        arc_ll = arcfb.score(fbank, all_utts) if all_utts else {}
        num_utts: List = []
        den_utts: List = []
        num_w: dict = {}
        den_w: dict = {}
        for role, lat, utts, a2n, it in jobs:
            for a in lat.arcs:
                nm = a2n.get(a.id)
                if nm is not None and nm in arc_ll:
                    a.aclike = arc_ll[nm]
            if it.get("mpe_ref") is not None:
                weights, c_avg = arc_mpe_weights(
                    lat, it["mpe_ref"], lmscale=lm_scale * kappa,
                    wdpenalty=0.0, null_words=null_words, acscale=kappa)
                num_utts.extend(utts)
                den_utts.extend(utts)
                # duplicate arcs fold linearly; positive parts feed the
                # numerator bucket, negative the denominator
                for aid, nm in a2n.items():
                    w = weights.get(aid, 0.0)
                    num_w[nm] = num_w.get(nm, 0.0) + (w if w > 0 else 0.0)
                    den_w[nm] = den_w.get(nm, 0.0) + (-w if w < 0 else 0.0)
                total_acc_exp += c_avg
                if ta.trace >= 2:
                    print(f"  {it['stem']}: expected accuracy {c_avg:.3f}")
                continue
            logp, post = arc_posteriors(lat, lmscale=lm_scale * kappa,
                                        wdpenalty=0.0, acscale=kappa)
            lat_lp[role] += float(logp)
            gam = {aid: (float(np.exp(min(g, 0.0))) if g > -30 else 0.0)
                   for aid, g in post.items()}
            t_utts, t_w = ((num_utts, num_w) if role == "num_lat"
                           else (den_utts, den_w))
            t_utts.extend(utts)
            for aid, nm in a2n.items():
                t_w[nm] = t_w.get(nm, 0.0) + gam.get(aid, 0.0)
            if role == "den_lat" and ta.trace >= 2:
                print(f"  {it['stem']}: den logP {logp:.2f}")
        # 3) one blocked accumulation pass per side (weights keyed by
        # arc-utterance name: arc ids collide across lattices)
        if num_utts:
            arcfb.accumulate(fbank, num_utts, num_w, num_total)
        if den_utts:
            arcfb.accumulate(fbank, den_utts, den_w, den_total)
        # 4) transcript numerators: one batched composite-FB call
        tutts = [it["num_utt"] for it in pend if it.get("num_utt")]
        if tutts:
            accs = trainer.accumulate(tutts, batch_size=acc_block)
            for a, b in zip(num_total, accs):
                a.add_(b)
        pend.clear()

    for fn in files:
        data, _p, _k, e = open_speech_file(fn, cfg)
        stem = os.path.splitext(os.path.basename(e.logical))[0]

        den_path = os.path.join(ta.get("r"), f"{stem}.lat")
        if not os.path.exists(den_path):
            HRError(12030, "HMMIRest: no denominator lattice for %s", stem)
            continue
        den_lat = read_slf(den_path, ta.config)
        if vocab is None:
            HError(1030, "HMMIRest: word lattices need a dictionary (-d)")
        item = {"stem": stem, "data": np.asarray(data, np.float32),
                "den_lat": den_lat}

        if mode in ("MPE", "MWE"):
            # MPE/MWE: positive/negative accuracy-weighted arc
            # occupancies from the same lattice; needs a *timed* word
            # reference (e.g. HVite -a output)
            tr = find_labels(e.logical, mlfs, ta.get("L"), ta.get("X", "lab"))
            ref = [(l.name, (l.start or 0) / 1e7, (l.end or 0) / 1e7)
                   for l in tr.labels]
            if not any(r[2] > r[1] for r in ref):
                HError(12040, "HMMIRest MPE: reference MLF for %s has no "
                              "times (align with HVite -a first)", stem)
            item["mpe_ref"] = ref
        elif ta.has("q"):
            item["num_lat"] = read_slf(
                os.path.join(ta.get("q"), f"{stem}.lat"), ta.config)
        else:
            tr = find_labels(e.logical, mlfs, ta.get("L"), ta.get("X", "lab"))
            names = [l.name for l in tr.labels]
            item["num_utt"] = prepare_utterance(comp, stem, item["data"],
                                                names)
        pend.append(item)
        if len(pend) >= acc_block:
            flush()
    flush()

    num_lp = float(num_total.total_logp.cpu())
    den_occ = float(den_total.occ.sum().cpu())
    num_occ = float(num_total.occ.sum().cpu())
    if ta.trace:
        print(f"HMMIRest: num occ {num_occ:.1f}, den occ {den_occ:.1f}, "
              f"num logP {num_lp:.2f}")
        print(f"HMMIRest: {n_arcs[0]} lattice arcs, {n_arcs[1]} arc "
              f"mini-utterances, {arcfb.launches['score']} score and "
              f"{arcfb.launches['accumulate']} accumulate launches")
        if mode == "MMI":
            # the MMI objective under the input model (lattices fixed):
            # numerator path logP (kappa-scaled to match the
            # denominator's exponent) minus the denominator lattice
            # total; it must rise across HMMIRest iterations
            num_side = (lat_lp["num_lat"] if ta.has("q")
                        else kappa * num_lp)
            print(f"HMMIRest: MMI criterion {num_side - lat_lp['den_lat']:.2f}"
                  f" (num {num_side:.2f}, den {lat_lp['den_lat']:.2f})")

    var_floor = hset.macros["v"].get("varFloor1")
    m, v, w = ebw_update(comp, _host(num_total), _host(den_total), ecfg,
                         var_floor)
    write_back(comp, means=m, variances=v, weights=w)

    out_dir = ta.get("M", ".")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, os.path.basename(mmfs[0]))
    save_mmf(hset, out, binary=ta.binary)
    if ta.trace:
        print(f"HMMIRest: saved {out}")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
