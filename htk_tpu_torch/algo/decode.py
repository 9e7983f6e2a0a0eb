"""Word-network Viterbi decoding (the HRec token-passing core) in torch.

The PyTorch counterpart of the 1-best decoders of `htk_tpu/algo/decode.py`
(general word networks and uniform-row LV networks). Per frame, over the
whole network:

  1. word-end scores   WE[i]   = segment-max of (v + aE) per word node
  2. cross-word step   entry[j] = max_i WE[i] + s*lm[i,j] + p
  3. within-word step  K shifted adds over the banded transition matrix
  4. combine + emit    v'[s] = max(within, entry) + outp[t, s]

On general nets the recursion runs in `ops/decode_scan.decode_scan`: the
hand-written CUDA kernel on the card, its plain torch version on the CPU.
Word-link records come back as per-frame (T, Nn) planes that host code
walks backwards for the 1-best transcription (`_finalize`, numpy,
unchanged from the JAX package).

Observation likelihoods come from one batched OutP over physical states
(ops/outp.GaussianScorer); network states gather rows (`comp_state`).

Networks with `uniform_width` (algo/lvnet.compile_lv_loop: one row per
(word, pron), every row padded to S states, node == row) take the
uniform-row LV decoder, the counterpart of the reference's
`decode_scan_uniform_batch`/`_lv_pipeline`: the word-end reduction is a
row max, word entry a row broadcast, and the cross-word step one of

  dense exact     entry[b, j] = max_i WE[b, i] + trans[i, j] through
                  ops/maxplus (the CUDA kernel csrc/maxplus.cu on the
                  card, its plain version on the CPU), one launch a frame
  dense top-A     only the `max_active` best word ends propagate (HLVRec's
                  maxModel pruning), as batched torch ops
  factored        (nets with `xw_backoff`, compile_lv_loop above 8,000
                  rows) the back-off leg max_i(WE[i] + bow[i]) + uni[j],
                  maxed with an explicit-bigram leg: exact, one
                  ops/xw_gather.segmax launch a frame over the buckets'
                  slots (csrc/xw_gather.cu on the card); top-A, a
                  scatter-max over the successor tables of the A best word
                  ends; adaptive-exact top-A (negative `max_active`), both
                  legs every frame and the exact one taken wherever the
                  certificate fails
  trigram-guided  (nets with `xw_trigram`) the factored legs over the
                  top-A word ends, each scored under its token's trigram
                  context

The frame loop runs in Python with OutP computed chunk-wise, then a
batched traceback walks the word-link records on the device and only the
(B, 3, T) path plane comes back to the host. The reference's hybrid
(`state_scores`) and adaptation (`model_params`) hooks and its opt-in
routed leg (`HTKTPU_XW_ROUTE`) are not taken.

Word lattices (HVite -z, and -n's N-best source) on general networks come
from the same word-end planes: `generate_lattice` (one utterance) and
`generate_lattice_batch` (a bucket through one decode launch, identical
output), the walk itself host numpy copied from the reference. Lattices
on uniform-row nets (the reference's `_lv_lattice_pipeline`) are not
ported yet and raise HError 8527.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.hmmset import CompiledHMMSet
from ..ops import maxplus as _maxplus
from ..ops import xw_gather as _xw_gather
from ..ops.decode_scan import decode_scan
from ..ops.outp import GaussianScorer
from ..utils.errors import HError
from ..utils.logmath import LZERO, LSMALL
from .net import DecodeNetwork

# word-link record packing for uniform-row nets: one int64 per state,
# (wn+1) << REC_TBITS | t, 0 = no record. The reference packs uint32;
# torch's uint32 coverage is thin, so the port packs int64 and keeps the
# reference's ranges (and HError 8520 beyond them).
REC_TBITS = 15
REC_TMASK = (1 << REC_TBITS) - 1          # max frame index (32767)
REC_MAXROWS = (1 << (32 - REC_TBITS)) - 2  # max (word, pron) rows (131k)

_BEAM_OFF = 1e30  # genBeam "off": never binds (scores live above LZERO)
_WALK_CHECK = 16  # traceback steps between checks that every path ended


@dataclass
class DecodeResult:
    words: List[str]  # output word sequence (suppressed symbols removed)
    word_nodes: List[int]  # node index per word
    times: List[Tuple[int, int]]  # (start_frame, end_frame) inclusive
    score: float  # total log likelihood (acoustic + scaled LM)
    scores: List[float]  # per-word segment scores


_XW3_TABLES = ("pair_u", "pair_bow", "pair_tstart", "pair_tcnt", "seg_start",
               "tri_j", "tri_p", "ctx_word")


def _xw_dev(x: dict, device) -> dict:
    """The factored cross-word tables on `device`. The buckets are
    flattened once into one segment table in layout order, pad slots
    (pred 0, score LZERO) kept: preds/scores (N,), seg_off (R+1,) and
    out_row (R,), each layout row's target row (the inverse of `inv`).
    Index tables the step scatters or gathers with are int64."""
    buckets = x["buckets"]
    widths = [[0]] + [np.full(len(p), p.shape[1]) for p, _ in buckets]

    def t(a, dtype=None):
        if a is None:
            return None
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    return {
        "bow": t(x["bow"], np.float32),
        "uni": t(x["uni"], np.float32),
        "succ_j": t(x.get("succ_j"), np.int64),
        "succ_p": t(x.get("succ_p"), np.float32),
        "marg": t(x.get("marg"), np.float32),
        "preds": t(np.concatenate([np.zeros(0, np.int32)] + [
            p.reshape(-1) for p, _ in buckets]), np.int32),
        "scores": t(np.concatenate([np.zeros(0, np.float32)] + [
            s.reshape(-1) for _, s in buckets]), np.float32),
        "seg_off": t(np.cumsum(np.concatenate(widths)), np.int32),
        "out_row": t(np.argsort(x["inv"]) if buckets else [], np.int32),
    }


def _net_dev(net: DecodeNetwork, device) -> dict:
    """Per-network tensor cache on `device`: the static network is
    pushed once per device and reused by every call."""
    device = torch.device(device)
    caches = getattr(net, "_torch_dev_cache", None)
    if caches is None:
        caches = net._torch_dev_cache = {}
    d = caches.get(str(device))
    if d is None:
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        d = {
            "band": f32(net.band),
            "a0": f32(net.a0),
            "aE": f32(net.aE),
            "trans": f32(net.trans),
            "start": f32(net.start_entry),
            "node_of_state": torch.as_tensor(
                np.asarray(net.node_of_chain[net.chain_of], np.int32),
                device=device),
            "entry_bonus": f32(net.chain_pron_prob[net.chain_of]),
            "comp_state": torch.as_tensor(
                np.asarray(net.comp_state, np.int64), device=device),
            "node_wdpen": (f32(net.node_wdpen)
                           if net.node_wdpen is not None else None),
            "bonus": f32(net.chain_pron_prob),  # (C,) per row, uniform nets
            "end_exit": f32(net.end_exit),
        }
        if net.xw_backoff is not None:
            d["xw"] = _xw_dev(net.xw_backoff, device)
        x3 = net.xw_trigram
        if x3 is not None:
            d["xw3"] = {k: torch.as_tensor(
                x3[k], dtype=torch.float32 if x3[k].dtype.kind == "f"
                else torch.int64, device=device) for k in _XW3_TABLES}
            d["xw3"]["o3max"] = x3["o3max"]
            d["xw3"]["iters"] = x3["iters"]
        caches[str(device)] = d
    return d


def _scale_xw(xw: Optional[dict], lm_scale: float) -> Optional[dict]:
    """The factored tables LM-scaled; once per decode call."""
    if xw is None:
        return None
    out = dict(xw)
    for k in ("bow", "uni", "scores", "succ_p", "marg"):
        if out[k] is not None:
            out[k] = out[k] * lm_scale
    return out


def _scale_xw3(x3: Optional[dict], lm_scale: float) -> Optional[dict]:
    """The trigram guidance tables LM-scaled; once per decode call."""
    if x3 is None:
        return None
    out = dict(x3)
    out["pair_bow"] = x3["pair_bow"] * lm_scale
    out["tri_p"] = x3["tri_p"] * lm_scale
    return out


def scorer_for(comp: CompiledHMMSet, device,
               precision: str = "highest") -> GaussianScorer:
    """The set's packed Gaussians on `device`, built once per
    (device, precision) and kept on the compiled set."""
    cache = getattr(comp, "_torch_scorers", None)
    if cache is None:
        cache = comp._torch_scorers = {}
    key = (str(torch.device(device)), precision)
    sc = cache.get(key)
    if sc is None:
        sc = cache[key] = GaussianScorer(comp, device, precision)
    return sc


def decode_operands(outp_states: torch.Tensor, net: DecodeNetwork,
                    lm_scale: float, word_pen: float) -> tuple:
    """`decode_scan`'s arguments for observation scores `outp_states`
    (B, T, Ns): the network's tensors on the same device, LM-scaled, and
    the per-node word penalty."""
    d = _net_dev(net, outp_states.device)
    # per-node word-insertion penalty: interior-sharing sub-word hops
    # (head->body->tail) must not collect -p again (net.py share_interiors)
    if d["node_wdpen"] is not None:
        wp = d["node_wdpen"] * float(word_pen)
    else:
        wp = torch.full((net.n_nodes,), float(word_pen), dtype=torch.float32,
                        device=outp_states.device)
    return (outp_states, d["band"], d["a0"], d["aE"], d["node_of_state"],
            d["entry_bonus"], d["trans"] * lm_scale, d["start"] * lm_scale,
            wp, net.n_nodes)


def _topa_mode(max_active):
    """Decode the max_active encoding.

    n > 0: top-A histogram pruning (HLVRec maxModel semantics).
    n < 0: ADAPTIVE-EXACT top-A, a feature of the factored cross-word leg
    (HError 8526 without its tables).
    Returns (A, adaptive)."""
    if max_active is None:
        return None, False
    return abs(int(max_active)), max_active < 0


def _shift_down_b(x, k, fill):
    """y[:, s] = x[:, s-k], with fill for s < k."""
    if k == 0:
        return x
    return torch.nn.functional.pad(x[:, :-k], (k, 0), value=fill)


def _unpack(rec):
    """Packed word-link records -> (wn, wt) int32; 0 gives (-1, -1)."""
    return (((rec >> REC_TBITS) - 1).to(torch.int32),
            ((rec & REC_TMASK) - 1).to(torch.int32))


def _top_a(WE, A: int):
    """The A best word ends (B, A) in jax.lax.top_k's order: descending,
    the lower row first on ties (a stable sort)."""
    vals, idxs = torch.sort(WE, dim=1, descending=True, stable=True)
    return vals[:, :A], idxs[:, :A]


def _scatter_max(cand, tgt, src, C: int):
    """Candidates cand (B, A, O) scattered to target rows tgt (B, A, O)
    int64 (pads at the dummy row C): per target the max, 2*LZERO where
    none lands, and the HIGHEST source row src (B, A) whose candidate
    reaches it, -1 where none (the reference's scatter-max tie rule,
    htk_tpu/algo/decode.py:572-581; the bucket leg keeps the first
    slot)."""
    B = cand.shape[0]
    tgt = tgt.reshape(B, -1)
    cand = cand.reshape(B, -1)
    ex = torch.full((B, C + 1), 2 * LZERO, dtype=torch.float32,
                    device=cand.device)
    ex.scatter_reduce_(1, tgt, cand, "amax", include_self=True)
    src = src[..., None].expand(-1, -1, tgt.shape[1] // src.shape[1])
    win = torch.where(cand >= ex.gather(1, tgt), src.reshape(B, -1), -1)
    anx = torch.full((B, C + 1), -1, dtype=torch.int64, device=cand.device)
    anx.scatter_reduce_(1, tgt, win, "amax", include_self=True)
    return ex[:, :C], anx[:, :C]


def _segmax_leg(WE, xw, C: int, skip=None):
    """The exact explicit-bigram leg: one segmax over the buckets' slots,
    written straight into target rows; unspecified where the device flag
    `skip` holds True."""
    return _xw_gather.segmax(WE, xw["preds"], xw["scores"], xw["seg_off"],
                             xw["out_row"], C, skip)


def _take(m, an, exp_v, exp_a):
    """Max the entry scores with an explicit leg; its source wins only
    where it is strictly better."""
    take = exp_v > m
    return torch.maximum(m, exp_v), torch.where(take, exp_a, an)


def _factored_leg(xw, C: int, A: Optional[int], adaptive: bool):
    """cross(WE, pwn) -> (m, an) (B, C) for the factored tables `xw`
    (LM-scaled): htk_tpu/algo/decode.py:546-643 without the routed hook.
    The reference picks adaptive-exact's leg with a lax.cond on one
    batch-wide certificate; here the certificate stays on the device:
    segmax launches every frame with it as its `skip` flag, so on the
    card its blocks return at once where the top-A leg is safe, and
    torch.where selects on the same flag. The frame loop never waits on
    the device, and the unspecified outputs of a skipped launch are only
    ever passed over by the where."""
    use_topa = A is not None and A < C and xw["succ_j"] is not None
    has_slots = xw["out_row"].numel() > 0
    bow_r, uni_r = xw["bow"][None], xw["uni"][None]

    def cross(WE, pwn):
        bo_best, bo_arg = torch.max(WE + bow_r, dim=1)
        m = bo_best[:, None] + uni_r
        an = bo_arg[:, None].expand_as(m)
        if use_topa:
            vals, idxs = _top_a(WE, A)
            cand = vals[..., None] + xw["succ_p"][idxs]  # (B, A, O)
            exp_v, exp_a = _scatter_max(cand, xw["succ_j"][idxs], idxs, C)
            if adaptive:
                # an excluded source i can beat the back-off floor
                # bo_best + uni[j] only if WE[i] + marg[i] > bo_best
                ex_m = (WE + xw["marg"][None]).scatter(1, idxs, 2 * LZERO)
                safe = (ex_m.amax(dim=1) <= bo_best).all()
                slow_v, slow_a = _segmax_leg(WE, xw, C, skip=safe)
                exp_v = torch.where(safe, exp_v, slow_v)
                exp_a = torch.where(safe, exp_a, slow_a)
        elif has_slots:
            exp_v, exp_a = _segmax_leg(WE, xw, C)
        else:
            return m, an
        return _take(m, an, exp_v, exp_a)

    return cross


def _trigram_leg(xw, x3, C: int, A: Optional[int]):
    """cross(WE, pwn) -> (m, an) (B, C) with single-pass trigram guidance
    (`xw3`, LM-scaled): htk_tpu/algo/decode.py:454-545. Every leg runs
    over the top-A word ends (all rows when A is off), each scored under
    its token's trigram context u = word(pwn)."""
    topa = A is not None and A < C
    P = x3["pair_u"].shape[0]
    o3 = x3["o3max"]

    def cross(WE, pwn):
        B = WE.shape[0]
        if topa:
            vals, idxs = _top_a(WE, A)
            uA = pwn.gather(1, idxs)
        else:
            idxs = torch.arange(C, device=WE.device)[None].expand(B, C)
            vals, uA = WE, pwn
        uw = x3["ctx_word"][torch.where(uA >= 0, uA, C).long()]
        # lower-bound search for (u, v) in the row's static pair segment,
        # step for step as the reference's
        lo = x3["seg_start"][idxs]
        hi0 = x3["seg_start"][idxs + 1]
        hi = hi0
        for _ in range(x3["iters"]):
            mid = (lo + hi) >> 1
            mu = x3["pair_u"][mid.clamp(max=P - 1)]
            go = (mid < hi) & (mu < uw)
            lo = torch.where(go, mid + 1, lo)
            hi = torch.where(go | (mid >= hi), hi, mid)
        loc = lo.clamp(max=P - 1)
        hit = (lo < hi0) & (x3["pair_u"][loc] == uw)
        vb = vals + torch.where(hit, x3["pair_bow"][loc], 0.0)
        bo_best, kbo = torch.max(vb + xw["bow"][idxs], dim=1, keepdim=True)
        m = bo_best + xw["uni"][None]
        an = idxs.gather(1, kbo).expand(B, C)
        if xw["succ_j"] is not None:
            cand = vb[..., None] + xw["succ_p"][idxs]
            m, an = _take(m, an, *_scatter_max(cand, xw["succ_j"][idxs],
                                               idxs, C))
        elif not topa and xw["out_row"].numel():
            # no successor tables: vb is row-aligned, so the exact bucket
            # leg applies unchanged
            m, an = _take(m, an, *_segmax_leg(vb, xw, C))
        if o3:
            st = torch.where(hit, x3["pair_tstart"][loc], 0)
            cn = torch.where(hit, x3["pair_tcnt"][loc], 0)
            sl = torch.arange(o3, device=WE.device)[None, None]
            valid = sl < cn[..., None]
            oc = torch.where(valid, st[..., None] + sl, 0)
            tjg = torch.where(valid, x3["tri_j"][oc], C)
            tpg = torch.where(valid, x3["tri_p"][oc], 2 * LZERO)
            m, an = _take(m, an, *_scatter_max(vals[..., None] + tpg, tjg,
                                               idxs, C))
        return m, an

    return cross


def _make_uniform_step(B, Ns, band, a0, aE, S, entry_bonus_row, trans,
                       start_entry, word_pen, beam, max_active, xw=None,
                       xw3=None):
    """The batched per-frame update as step(carry, outp_t, t), for
    uniform-row nets (htk_tpu/algo/decode.py : _make_uniform_step).
    carry = (v (B, Ns) f32, rec (B, Ns) int64 packed records); returns the
    next carry and this frame's word-end records (WE, pwn, pwt), each
    (B, C). `t` is the Python frame index, `beam` and `word_pen` Python
    floats, so the step never waits on the device. `xw`/`xw3` are the
    factored and trigram tables of `_net_dev`, LM-scaled (`_scale_xw`,
    `_scale_xw3`). The operations run in the reference's order, which
    keeps the scores bit-equal to it on the same outp."""
    C = Ns // S
    K = band.shape[0]
    max_active, adaptive = _topa_mode(max_active)
    if C >= REC_MAXROWS:
        HError(8520, "decode_scan_uniform_batch: %d rows exceed the "
                     "packed-record range (%d)", C, REC_MAXROWS)
    if adaptive and (xw is None or xw3 is not None
                     or xw.get("succ_j") is None
                     or not xw["out_row"].numel()
                     or xw.get("marg") is None):
        HError(8526, "adaptive-exact top-A needs the factored cross-word "
                     "tables with successor tables and buckets (and is "
                     "not combined with trigram guidance, which is "
                     "already a top-A semantic)")
    if xw3 is not None:
        if xw is None:
            HError(8526, "trigram guidance needs the factored cross-word "
                         "tables (compile_lv_loop(factored=True))")
        if (xw.get("succ_j") is None and max_active is not None
                and max_active < C):
            HError(8526, "trigram guidance with top-A pruning needs the "
                         "bigram successor tables (out-degree too skewed "
                         "at this vocabulary) — decode without -u or "
                         "disable HDECODE: TRIGUIDE")
    topa = max_active is not None and max_active < C
    beam_on = beam is not None and beam < _BEAM_OFF
    a0_r = a0.reshape(C, S)[None]
    aE_r = aE[None]
    bonus_r = entry_bonus_row[None]
    start_r = start_entry[None].expand(B, C)
    if xw3 is not None:
        cross = _trigram_leg(xw, xw3, C, max_active)
    elif xw is not None:
        cross = _factored_leg(xw, C, max_active, adaptive)
    else:
        cross = None

    def step(carry, outp_t, t: int):
        v, rec = carry
        ev = (v + aE_r).reshape(B, C, S)
        WE, best_s = torch.max(ev, dim=2)  # first maximising state
        ok = WE > LSMALL
        prec = rec.reshape(B, C, S).gather(2, best_s[..., None])[..., 0]
        pwn, pwt = _unpack(torch.where(ok, prec, 0))

        if cross is not None:
            m, an = cross(WE, pwn)
        elif topa:
            vals, idxs = _top_a(WE, max_active)
            cand = vals[..., None] + trans[idxs]  # (B, A, C)
            m, k = torch.max(cand, dim=1)
            an = idxs.gather(1, k)
        else:
            m, an = _maxplus.maxplus(WE, trans, floor=False)
        # the reference computes the step at every frame and takes the
        # start entry at t == 0, with no record
        if t == 0:
            entry_n = start_r
            entry_rec = torch.zeros_like(rec[:, :C])
        else:
            entry_n = m + word_pen
            entry_rec = ((an.to(torch.int64) + 1) << REC_TBITS) | t
        entry_flat = ((entry_n + bonus_r)[..., None] + a0_r).reshape(B, Ns)
        erec_flat = entry_rec[..., None].expand(B, C, S).reshape(B, Ns)

        # within-word band; the incremental max keeps the first shift on
        # ties (the band masks row boundaries)
        within = v + band[0][None]
        wrec = rec
        for k in range(1, K):
            ck = _shift_down_b(v, k, LZERO) + band[k][None]
            take = ck > within
            within = torch.where(take, ck, within)
            wrec = torch.where(take, _shift_down_b(rec, k, 0), wrec)

        use_entry = entry_flat > within
        new_v = torch.maximum(within, entry_flat) + outp_t
        if beam_on:
            top = new_v.max(dim=1, keepdim=True).values
            new_v = torch.where(new_v < top - beam, LZERO, new_v)
        new_rec = torch.where(use_entry, erec_flat, wrec)
        new_rec = torch.where(new_v <= LSMALL, 0, new_rec)
        return (new_v, new_rec), (WE, pwn, pwt)

    return step


def _uniform_init(B, Ns, device):
    return (torch.full((B, Ns), LZERO, dtype=torch.float32, device=device),
            torch.zeros((B, Ns), dtype=torch.int64, device=device))


def decode_scan_uniform_batch(
    outp_states,  # (B, T, Ns)
    band, a0, aE,
    S: int,
    entry_bonus_row,  # (C,)
    trans,  # (C, C) scaled
    start_entry,  # (C,)
    word_pen: float,
    beam: float = _BEAM_OFF,
    max_active: Optional[int] = None,
    xw: Optional[dict] = None,
    xw3: Optional[dict] = None,
):
    """Batched uniform-row scan over precomputed outp: returns
    ((v, wn, wt) (B, Ns), (WEs, pwns, pwts) (B, T, C)), the layout of the
    reference's `decode_scan_uniform_batch`. `xw`/`xw3`: the factored and
    trigram tables of `_net_dev`, LM-scaled (`_scale_xw`, `_scale_xw3`);
    `trans` is then the net's empty (0, 0) matrix."""
    B, T, Ns = outp_states.shape
    step = _make_uniform_step(
        B, Ns, band, a0, aE, S, entry_bonus_row, trans, start_entry,
        word_pen, beam, max_active, xw, xw3)
    if T > REC_TMASK:
        HError(8520, "decode_scan_uniform_batch: %d frames exceed the "
                     "packed-record range (%d — chunk longer audio)",
               T, REC_TMASK)
    carry = _uniform_init(B, Ns, outp_states.device)
    recs = []
    for t in range(T):
        carry, r = step(carry, outp_states[:, t], t)
        recs.append(r)
    v, rec = carry
    return (v, *_unpack(rec)), tuple(
        torch.stack(p, dim=1) for p in zip(*recs))


def _traceback_device(vb, wnb, wtb, WEb, pwnb, pwtb, aE, end_exit_s,
                      t_reals, S: int):
    """Batched record walk on the device for uniform-row nets
    (htk_tpu/algo/decode.py : _traceback_device).

    Finalises each utterance from plane row t_real when t_real < T (ends
    at t_real-1 are emitted by scan step t_real), else from the final
    carry; then walks the backpointers with two gathers a step for the
    whole batch. Returns the (B, 3, T) int32 plane of (node, t_start,
    t_end) per step in reverse order, -1 padded, and the (B,) path scores.
    The reference scans all T steps; this stops once every path has
    ended, checked every _WALK_CHECK steps (the rest is -1 either way).
    """
    B, T, C = WEb.shape
    dev = WEb.device
    i32 = torch.int32
    ev = (vb + aE[None]).reshape(B, C, S)
    WEl, best_s = torch.max(ev, dim=2)
    okl = WEl > LSMALL

    def last(x):
        return torch.where(
            okl, x.reshape(B, C, S).gather(2, best_s[..., None])[..., 0], -1)

    tr = torch.as_tensor(t_reals, dtype=torch.int64, device=dev)
    use_last = (tr >= T)[:, None]
    trc = tr.clamp(0, T - 1)
    bi = torch.arange(B, device=dev)
    WE_fin = torch.where(use_last, WEl, WEb[bi, trc])
    pwn_fin = torch.where(use_last, last(wnb), pwnb[bi, trc])
    pwt_fin = torch.where(use_last, last(wtb), pwtb[bi, trc])

    score, i0 = torch.max(WE_fin + end_exit_s[None], dim=1)
    ok = score > LSMALL
    node = i0.to(i32)
    t = (tr - 1).to(i32)
    pn = torch.where(ok, pwn_fin[bi, i0], -1)
    pt = torch.where(ok, pwt_fin[bi, i0], -1)
    alive = ok
    out = torch.full((B, 3, T), -1, dtype=i32, device=dev)
    steps = []
    for k in range(T):
        steps.append(torch.where(alive[:, None],
                                 torch.stack([node, pt + 1, t], dim=1), -1))
        stop = (pn < 0) | (pt < 0)
        it = (pt + 1).clamp(0, T - 1).long()
        inn = pn.clamp(0, C - 1).long()
        npn = torch.where(stop, -1, pwnb[bi, it, inn])
        npt = torch.where(stop, -1, pwtb[bi, it, inn])
        node = torch.where(stop, node, pn)
        t = torch.where(stop, t, pt)
        pn, pt = npn, npt
        alive = alive & ~stop
        if (k + 1) % _WALK_CHECK == 0 and not bool(alive.any()):
            break
    out[:, :, :len(steps)] = torch.stack(steps, dim=2)
    return out, score


def run_decode_batch(
    outp_states: torch.Tensor,  # (B, T, Ns), on the decode device
    net: DecodeNetwork,
    lm_scale: float,
    word_pen: float,
    beam: Optional[float] = None,
    max_active: Optional[int] = None,
):
    """Run the decode recursion on the device `outp_states` lies on;
    returns ((v, wn, wt), (WE, pwn, pwt)) as `decode_scan` does: the
    uniform-row scan for lvnet networks (records (B, T, C)), the general
    recursion otherwise.

    On general networks `beam`/`max_active` are accepted for the caller's
    retry ladder and, as in the reference's general-network branch, not
    read."""
    if net.uniform_width:
        d = _net_dev(net, outp_states.device)
        return decode_scan_uniform_batch(
            outp_states, d["band"], d["a0"], d["aE"], net.uniform_width,
            d["bonus"], d["trans"] * lm_scale, d["start"] * lm_scale,
            float(word_pen), _BEAM_OFF if beam is None else float(beam),
            max_active, _scale_xw(d.get("xw"), lm_scale),
            _scale_xw3(d.get("xw3"), lm_scale))
    return decode_scan(*decode_operands(outp_states, net, lm_scale,
                                        word_pen))


def _final_records(net, v, wn, wt):
    """Per-node word-end records from the final state vector."""
    nos = np.asarray(net.node_of_chain[net.chain_of])
    e_state = np.asarray(v) + np.asarray(net.aE)
    wn = np.asarray(wn)
    wt = np.asarray(wt)
    Nn = net.n_nodes
    WE_fin = np.full(Nn, LZERO, np.float64)
    pwn_fin = np.full(Nn, -1, np.int64)
    pwt_fin = np.full(Nn, -1, np.int64)
    for s in np.argsort(-e_state):
        i = nos[s]
        if e_state[s] > WE_fin[i]:
            WE_fin[i] = e_state[s]
            pwn_fin[i] = wn[s]
            pwt_fin[i] = wt[s]
    return WE_fin, pwn_fin, pwt_fin


def _finalize(net, WEs, pwns, pwts, WE_fin, pwn_fin, pwt_fin, T_real,
              lm_scale) -> Optional[DecodeResult]:
    """Pick the best complete path and walk the word-link records back."""
    final = WE_fin + np.asarray(net.end_exit, np.float64) * lm_scale
    i = int(np.argmax(final))
    if final[i] <= LSMALL:
        return None
    score = float(final[i])

    words_rev: List[Tuple[int, int, int]] = []  # (node, t_start, t_end)
    t = T_real - 1
    node = i
    pn, pt = int(pwn_fin[i]), int(pwt_fin[i])
    while True:
        words_rev.append((node, pt + 1, t))
        if pn < 0 or pt < 0:
            break
        node, t = pn, pt
        # records for end time t live in scan step t+1
        pn = int(pwns[t + 1, node])
        pt = int(pwts[t + 1, node])

    words_rev.reverse()
    return _result_from_chain(net, words_rev, score)


def _result_from_chain(net, words_fwd, score) -> DecodeResult:
    """(node, t_start, t_end) chain in forward order -> DecodeResult."""
    words, nodes, times, scores = [], [], [], []
    cont = net.node_cont
    pend_t0: Optional[int] = None  # head/body spans merge into the tail
    for node, t0, t1 in words_fwd:
        if cont is not None and cont[node]:
            if pend_t0 is None:
                pend_t0 = t0
            continue
        out = net.node_out[node]
        sym = net.node_words[node] if out is None else out
        if sym:
            words.append(sym)
            nodes.append(node)
            times.append((pend_t0 if pend_t0 is not None else t0, t1))
            scores.append(0.0)
        pend_t0 = None
    return DecodeResult(
        words=words, word_nodes=nodes, times=times, score=score, scores=scores
    )


def _net_outp(net, comp, feats, precision, device) -> torch.Tensor:
    """(..., T, Ns) network-state observation log-likelihoods on `device`
    from frames (..., T, D)."""
    x = torch.as_tensor(np.asarray(feats, np.float32), device=device)
    logb = scorer_for(comp, device, precision)(x)
    return logb[..., _net_dev(net, device)["comp_state"]].contiguous()


def _lv_chunk(T: int, B: int, Ns: int) -> int:
    """Frames of OutP computed at a time: 64, 32, 16 or 8 dividing T
    (else all of T), halved while the (B, CH, Ns) chunk exceeds 1 GiB."""
    CH = T
    for c in (64, 32, 16, 8):
        if T % c == 0:
            CH = c
            break
    while (CH > 8 and CH % 2 == 0 and T % (CH // 2) == 0
           and B * CH * Ns * 4 > 1 << 30):
        CH //= 2
    return CH


def _lv_scan_body(net, comp, d, precision, max_active, x, lm_scale,
                  word_pen, beam):
    """The uniform-row scan with OutP computed chunk-wise inside the frame
    loop (the full (B, T, Ns) plane is never formed). Returns the final
    carry (v, rec) and the word-end record planes WEs/pwns/pwts in
    (B, T, C) layout (plane t = word ends at time t-1)."""
    S = net.uniform_width
    B, T = x.shape[0], x.shape[1]
    Ns = len(net.comp_state)
    step = _make_uniform_step(
        B, Ns, d["band"], d["a0"], d["aE"], S, d["bonus"],
        d["trans"] * lm_scale, d["start"] * lm_scale, word_pen, beam,
        max_active, _scale_xw(d.get("xw"), lm_scale),
        _scale_xw3(d.get("xw3"), lm_scale))
    scorer = scorer_for(comp, x.device, precision)
    CH = _lv_chunk(T, B, Ns)
    carry = _uniform_init(B, Ns, x.device)
    recs = []
    for c in range(T // CH):
        outp_chunk = scorer(x[:, c * CH:(c + 1) * CH])[..., d["comp_state"]]
        for tl in range(CH):
            carry, r = step(carry, outp_chunk[:, tl], c * CH + tl)
            recs.append(r)
    WEs, pwns, pwts = (torch.stack(p, dim=1) for p in zip(*recs))
    return carry, WEs, pwns, pwts


def _lv_pipeline(net, comp, x, t_reals, lm_scale, word_pen, beam,
                 max_active, precision):
    """OutP -> scan -> device traceback for frames x (B, T, D) on their
    device; returns the (B, 3, T) path plane and the (B,) scores, both on
    the device. The network's tensors come from the per-net cache."""
    d = _net_dev(net, x.device)
    (v, rec), WEs, pwns, pwts = _lv_scan_body(
        net, comp, d, precision, max_active, x, lm_scale, word_pen, beam)
    return _traceback_device(v, *_unpack(rec), WEs, pwns, pwts, d["aE"],
                             d["end_exit"] * lm_scale, t_reals,
                             net.uniform_width)


def _decode_uniform(net, comp, x, t_reals, lm_scale, word_pen, beam,
                    max_active, precision, device):
    # the packed word-link record carries a 15-bit frame field; past it
    # the frame index would overflow into the row bits (callers chunk
    # long utterances before reaching this point)
    if x.shape[1] > REC_TMASK:
        HError(8520, "decode: %d frames exceed the packed record's "
                     "15-bit frame field (max %d) — chunk the utterance",
               x.shape[1], REC_TMASK)
    x = torch.as_tensor(np.asarray(x, np.float32), device=device)
    packed, scores = _lv_pipeline(
        net, comp, x, t_reals, float(lm_scale), float(word_pen),
        _BEAM_OFF if beam is None else float(beam), max_active, precision)
    p = packed.cpu().numpy()  # (B, 3, T): one transfer for all planes
    return _format_uniform_results(net, p[:, 0], p[:, 1], p[:, 2],
                                   scores.cpu().numpy())


def _format_uniform_results(net, nodes_b, t0_b, t1_b, scores_b):
    out: List[Optional[DecodeResult]] = []
    for b in range(nodes_b.shape[0]):
        if scores_b[b] <= LSMALL:
            out.append(None)
            continue
        words, nds, times, wscores = [], [], [], []
        valid = nodes_b[b] >= 0
        for k in range(int(valid.sum()) - 1, -1, -1):  # reverse order
            node = int(nodes_b[b, k])
            sym = net.node_out[node]
            sym = net.node_words[node] if sym is None else sym
            if sym:
                words.append(sym)
                nds.append(node)
                times.append((int(t0_b[b, k]), int(t1_b[b, k])))
                wscores.append(0.0)
        out.append(DecodeResult(words=words, word_nodes=nds, times=times,
                                score=float(scores_b[b]), scores=wscores))
    return out


# auto-chunk target length: comfortably under REC_TMASK so the cut-
# point search window never pushes a chunk over the record range
CHUNK_T = 30_000
CHUNK_WINDOW = 2_000


def _decode_chunked(net, comp, feats, lm_scale, word_pen, precision, beam,
                    max_active, device):
    """Decode an over-long utterance on a uniform-row net as concatenated
    chunks (htk_tpu/algo/decode.py : _decode_chunked).

    Cut points land on the LOWEST-ENERGY frame (smallest feature L2
    norm) inside the window [CHUNK_T - CHUNK_WINDOW, CHUNK_T) of each
    remaining span, so a word rarely straddles a cut. Results are the
    concatenation of the chunk decodes with times offset; the score is
    the sum (the cross-chunk LM transition is dropped — the approximation
    inherent to chunking).
    """
    cuts = [0]
    pos = 0
    T = feats.shape[0]
    while T - pos > CHUNK_T:
        w0 = pos + CHUNK_T - CHUNK_WINDOW
        w1 = pos + CHUNK_T
        norms = np.linalg.norm(np.asarray(feats[w0:w1]), axis=1)
        pos = w0 + int(np.argmin(norms))
        cuts.append(pos)
    cuts.append(T)

    words: List[str] = []
    nodes: List[int] = []
    times: List[Tuple[int, int]] = []
    wscores: List[float] = []
    score = 0.0
    any_ok = False
    for c0, c1 in zip(cuts[:-1], cuts[1:]):
        # chunks pad to a 128 multiple, as the reference's do
        tc = c1 - c0
        tp = ((tc + 127) // 128) * 128
        chunk = np.asarray(feats[c0:c1], np.float32)
        xb = np.zeros((1, tp, chunk.shape[1]), np.float32)
        xb[0, :tc] = chunk
        r = _decode_uniform(net, comp, xb, [tc], lm_scale, word_pen, beam,
                            max_active, precision, device)[0]
        if r is None:
            continue
        any_ok = True
        words.extend(r.words)
        nodes.extend(r.word_nodes)
        times.extend([(t0 + c0, t1 + c0) for t0, t1 in r.times])
        wscores.extend(r.scores)
        score += r.score
    if not any_ok:
        return None
    return DecodeResult(words=words, word_nodes=nodes, times=times,
                        score=score, scores=wscores)


def decode(
    net: DecodeNetwork,
    comp: CompiledHMMSet,
    feats: np.ndarray,
    lm_scale: float = 1.0,
    word_pen: float = 0.0,
    precision: str = "highest",
    beam: Optional[float] = None,
    max_active: Optional[int] = None,
    *,
    device,
) -> Optional[DecodeResult]:
    """Decode one utterance on `device`; returns None if no complete path
    survives. On uniform-row nets an utterance longer than the packed
    record's frame range (REC_TMASK) is decoded in chunks."""
    T = feats.shape[0]
    if net.uniform_width:
        if T > REC_TMASK:
            return _decode_chunked(net, comp, feats, lm_scale, word_pen,
                                   precision, beam, max_active, device)
        return _decode_uniform(net, comp, feats[None], [T], lm_scale,
                               word_pen, beam, max_active, precision,
                               device)[0]
    outp_states = _net_outp(net, comp, feats[None], precision, device)
    (vb, wnb, wtb), (WEs, pwns, pwts) = run_decode_batch(
        outp_states, net, lm_scale, word_pen,
        beam=beam, max_active=max_active,
    )
    WE_fin, pwn_fin, pwt_fin = _final_records(
        net, vb[0].cpu().numpy(), wnb[0].cpu().numpy(), wtb[0].cpu().numpy())
    return _finalize(net, WEs[0].cpu().numpy(), pwns[0].cpu().numpy(),
                     pwts[0].cpu().numpy(), WE_fin, pwn_fin, pwt_fin, T,
                     lm_scale)


def decode_batch(
    net: DecodeNetwork,
    comp: CompiledHMMSet,
    feats_list: List[np.ndarray],
    lm_scale: float = 1.0,
    word_pen: float = 0.0,
    precision: str = "highest",
    pad_to: int = 128,
    beam: Optional[float] = None,
    max_active: Optional[int] = None,
    *,
    device,
) -> List[Optional[DecodeResult]]:
    """Decode a batch of utterances together on `device`: one decode
    launch on general nets, one uniform-row scan on lvnet nets (one
    maxplus launch a frame on the dense exact leg, one segmax launch a
    frame on the factored exact and adaptive legs).

    Utterances are zero-padded to a common frame count rounded up to
    `pad_to`. Padding never affects results: the recursion is causal and
    each utterance finalises from the word-end plane at its own t_real
    (WEs[t] holds the ends at time t-1). Identical output to `decode`
    per utterance. On uniform-row nets, utterances longer than REC_TMASK
    frames go through `decode` (chunked) one by one, the rest batch.
    """
    B = len(feats_list)
    lens = [int(f.shape[0]) for f in feats_list]
    if net.uniform_width and max(lens) > REC_TMASK:
        out: List[Optional[DecodeResult]] = [None] * B
        short = [b for b in range(B) if lens[b] <= REC_TMASK]
        for b in range(B):
            if lens[b] > REC_TMASK:
                out[b] = decode(net, comp, feats_list[b], lm_scale,
                                word_pen, precision, beam=beam,
                                max_active=max_active, device=device)
        if short:
            rs = decode_batch(net, comp, [feats_list[b] for b in short],
                              lm_scale, word_pen, precision, pad_to, beam,
                              max_active, device=device)
            for b, r in zip(short, rs):
                out[b] = r
        return out
    T = ((max(lens) + pad_to - 1) // pad_to) * pad_to
    D = feats_list[0].shape[1]
    fb = np.zeros((B, T, D), np.float32)
    for b, f in enumerate(feats_list):
        fb[b, : lens[b]] = f

    if net.uniform_width:
        return _decode_uniform(net, comp, fb, lens, lm_scale, word_pen,
                               beam, max_active, precision, device)
    outp = _net_outp(net, comp, fb, precision, device)
    (vb, wnb, wtb), (WEb, pwnb, pwtb) = run_decode_batch(
        outp, net, lm_scale, word_pen, beam=beam, max_active=max_active)
    WEb = WEb.cpu().numpy()
    pwnb = pwnb.cpu().numpy()
    pwtb = pwtb.cpu().numpy()
    vb, wnb, wtb = vb.cpu().numpy(), wnb.cpu().numpy(), wtb.cpu().numpy()

    out: List[Optional[DecodeResult]] = []
    for b in range(B):
        tr = lens[b]
        if tr == T:
            WE_fin, pwn_fin, pwt_fin = _final_records(
                net, vb[b], wnb[b], wtb[b])
        else:
            # ends at time tr-1 were emitted by scan step tr
            WE_fin = WEb[b, tr].astype(np.float64)
            pwn_fin = pwnb[b, tr].astype(np.int64)
            pwt_fin = pwtb[b, tr].astype(np.int64)
        out.append(_finalize(net, WEb[b], pwnb[b], pwtb[b], WE_fin,
                             pwn_fin, pwt_fin, tr, lm_scale))
    return out


# ---------------------------------------------------------------------------
# Word lattices (HVite -z, and the N-best source of -n)
# ---------------------------------------------------------------------------
#
# The lattice records are the same word-end planes the 1-best walks: one
# lattice node per (word node, end time) record with its best predecessor.
# The planes come from `run_decode_batch` (the decode kernel on the card);
# everything after that is host numpy copied from htk_tpu/algo/decode.py
# (`_lattice_from_host_planes`, `_lattice_from_rec`, the dense leg of
# `_host_lm_lookup`), so the same planes give byte-identical SLF. Lattices
# on uniform-row (LV) nets, with their factored and trigram LM lookups and
# the HDECODE: LATPREDS alternative arcs, wait for `_lv_lattice_pipeline`:
# both generators raise HError 8527 on such nets.


# (node, t) record keys pack into one int64 so record lookups become
# sorted-array searches instead of dict walks: t is bounded by the
# 15-bit traceback field (auto-chunked above 32767 frames) and node ids
# by the 17+4-bit word-link row space, so node * 2^22 + (t + 2) cannot
# collide or overflow
_REC_PK = np.int64(1) << 22



def _refuse_uniform(net, who):
    if net.uniform_width:
        HError(8527, f"{who}: lattices on uniform-row (LV) networks are "
                     "not yet ported to htk_tpu_torch")


def _host_lm_lookup(net):
    """Host-side row-to-row LM scores of a general net's dense `trans`,
    vectorised over int64 arrays (pn, i)."""
    # cache the f64 view: the (R, R) conversion is ~50 ms at 5k vocab and
    # this is called once per utterance in the batched lattice walk
    trans_np = getattr(net, "_trans_np64", None)
    if trans_np is None:
        trans_np = net._trans_np64 = np.asarray(net.trans, np.float64)
    return lambda pn, i: trans_np[pn, i]


def generate_lattice(
    net: DecodeNetwork,
    comp: CompiledHMMSet,
    feats: np.ndarray,
    lm_scale: float = 1.0,
    word_pen: float = 0.0,
    lattice_beam: float = 200.0,
    frame_period_s: float = 0.01,
    precision: str = "highest",
    want_result: bool = False,
    beam: Optional[float] = None,
    max_active: Optional[int] = None,
    *,
    device,
):
    """Decode one utterance on `device` and emit a word lattice (HVite -z).

    Matches HVite's lattice semantics: one lattice node per (word node,
    end time) word-link record, each with its single best predecessor
    (HRec.c LatFromPaths). Records scoring worse than `lattice_beam`
    below the best record at the same frame are dropped. General networks
    only: a uniform-row (LV) net raises HError 8527, as in
    `generate_lattice_batch`.

    `want_result=True` additionally returns the 1-best DecodeResult from
    the same recursion, so HVite -z needs one decode, not two. The
    reference's `state_scores` and `model_params` hooks are not taken.
    """
    _refuse_uniform(net, "generate_lattice")
    T = feats.shape[0]
    outp_states = _net_outp(net, comp, feats[None], precision, device)
    (vb, wnb, wtb), (WEb, pwnb, pwtb) = run_decode_batch(
        outp_states, net, lm_scale, word_pen,
        beam=beam, max_active=max_active,
    )
    return _lattice_from_host_planes(
        net, WEb[0].cpu().numpy(), pwnb[0].cpu().numpy(),
        pwtb[0].cpu().numpy(),
        (vb[0].cpu().numpy(), wnb[0].cpu().numpy(), wtb[0].cpu().numpy()),
        None, T, lattice_beam, frame_period_s, lm_scale, word_pen,
        want_result)


def _lattice_from_host_planes(net, WEs, pwns, pwts, carry, fin, T,
                              lattice_beam, frame_period_s, lm_scale,
                              word_pen, want_result):
    """Lattice (+ optional 1-best) from host-fetched word-end planes.

    `WEs/pwns/pwts` cover scan steps 0..T-1 (step t holds ends at time
    t-1). Final-frame (T-1) records come from `fin` =
    (WE_fin, pwn_fin, pwt_fin) when given — the padded-batch case, where
    they are plane T of the full scan — else from `carry` = (v, wn, wt),
    the final state vector of an unpadded scan. Shared by the sequential
    and generic-batched generators (identical output, tested)."""
    if fin is not None:
        WE_fin = np.asarray(fin[0], np.float64)
        pwn_fin = np.asarray(fin[1], np.int64)
        pwt_fin = np.asarray(fin[2], np.int64)
    else:
        v, wn, wt = carry
        # final-frame records
        v = np.asarray(v)
        wn = np.asarray(wn)
        wt = np.asarray(wt)
        nos = np.asarray(net.node_of_chain[net.chain_of])
        e_state = np.asarray(v + np.asarray(net.aE), np.float64)
        Nn = net.n_nodes
        WE_fin = np.full(Nn, LZERO, np.float64)
        pwn_fin = np.full(Nn, -1, np.int64)
        pwt_fin = np.full(Nn, -1, np.int64)
        # per-node max over states; stable sort keeps the FIRST state
        # among equal scores, matching the former strict-greater scan
        s_ord = np.argsort(-e_state, kind="stable")
        i_ord = nos[s_ord]
        _uniq, first = np.unique(i_ord, return_index=True)
        sel = s_ord[first]
        win = e_state[sel] > LZERO
        WE_fin[i_ord[first][win]] = e_state[sel][win]
        pwn_fin[i_ord[first][win]] = np.asarray(wn, np.int64)[sel][win]
        pwt_fin[i_ord[first][win]] = np.asarray(wt, np.int64)[sel][win]

    # records table: rec[(node, t)] = (score, pred_node, pred_t) — one
    # vectorised pass over the (T-1, Nn) plane (the per-frame per-node
    # Python loop dominated sequential lattice generation); np.nonzero's
    # row-major order IS the former (t asc, node asc) insertion order
    rec = {}
    rows = np.asarray(WEs[1:T])  # native plane dtype: beam comparisons
    # round exactly like the former per-element loop (and the batch path)
    best = rows.max(axis=1, keepdims=True) if T > 1 else rows
    mask = (best > LSMALL) & (rows > LSMALL) & (rows >= best - lattice_beam)
    tt, ii = np.nonzero(mask)
    rec.update(zip(
        zip(ii.tolist(), tt.tolist()),
        zip(rows[tt, ii].tolist(),
            np.asarray(pwns)[tt + 1, ii].tolist(),
            np.asarray(pwts)[tt + 1, ii].tolist())))
    bestf = WE_fin.max()
    fkeep = np.nonzero((WE_fin > LSMALL)
                       & (WE_fin >= bestf - lattice_beam))[0]
    for i_ in fkeep.tolist():
        rec[(i_, T - 1)] = (float(WE_fin[i_]), int(pwn_fin[i_]),
                            int(pwt_fin[i_]))
    res = None
    if want_result:
        res = _finalize(net, WEs, pwns, pwts, WE_fin.astype(np.float64),
                        pwn_fin.astype(np.int64), pwt_fin.astype(np.int64),
                        T, lm_scale)
    if not rec:
        return (None, res) if want_result else None

    def resolve(pn, pt):
        score = float(WEs[pt + 1, pn]) if pt < T - 1 else float(WE_fin[pn])
        if score <= LSMALL:
            return None
        ppn = int(pwns[pt + 1, pn]) if pt < T - 1 else int(pwn_fin[pn])
        ppt = int(pwts[pt + 1, pn]) if pt < T - 1 else int(pwt_fin[pn])
        return score, ppn, ppt

    lat = _lattice_from_rec(net, rec, resolve, T, frame_period_s,
                            lm_scale, word_pen)
    return (lat, res) if want_result else lat



def _lattice_from_rec(net, rec, resolve, T_real, frame_period_s,
                      lm_scale, word_pen):
    """Build a Lattice from beam-kept word-end records, each with its
    single best predecessor (HRec.c LatFromPaths).

    `rec`: {(node, t): (score, pred_node, pred_t)} in deterministic
    insertion order; `resolve(pn, pt)` recovers a record that the beam
    dropped (returns (score, ppn, ppt) or None when unavailable). Shared
    by the sequential and batched lattice generators so both emit
    byte-identical SLF for identical record sets.
    """
    from ..io.slf import Lattice, LArc, LNode, NULL_WORD

    _PK = _REC_PK

    def _rec_arrays():
        # rec INSERTION order — it defines arc emission order
        ka = np.asarray(list(rec), np.int64).reshape(len(rec), 2)
        va = np.asarray(list(rec.values()), np.float64).reshape(
            len(rec), 3)
        return (ka[:, 0], ka[:, 1], va[:, 0],
                va[:, 1].astype(np.int64), va[:, 2].astype(np.int64))

    ii, tt_, sc, pn_a, pt_a = _rec_arrays()
    n = ii.size
    pk = ii * _PK + (tt_ + 2)
    srt = np.argsort(pk, kind="stable")
    pks = pk[srt]

    def _pred_rows(m):
        # rows (in rec insertion order) holding each m-row's (pn, pt)
        pos = np.searchsorted(pks, pn_a[m] * _PK + (pt_a[m] + 2))
        return pos, srt

    # Transitively retain predecessor records referenced by survivors:
    # a beam keeps the best ends per frame, but a kept record's traceback
    # may point at a pruned (pn, pt) — HTK's LatFromPaths never emits arcs
    # to pruned predecessors, so resurrect them from the word-end planes
    # (their scores are still there) rather than rerouting to the start.
    # Breadth-first waves: each wave's missing predecessors resolve,
    # then their own predecessors form the next wave. The seed wave is
    # found vectorised.
    m_ref = pn_a >= 0
    if m_ref.any():
        pos, _ = _pred_rows(m_ref)
        ok = (pos < n) & (pks[np.minimum(pos, n - 1)]
                          == pn_a[m_ref] * _PK + (pt_a[m_ref] + 2))
        miss = np.nonzero(m_ref)[0][~ok]
    else:
        miss = np.empty(0, np.int64)
    if miss.size:
        keys0 = list(rec)
        frontier = [keys0[j] for j in miss.tolist()]
        while frontier:
            need = []
            referrers: dict = {}
            for key in frontier:
                _, pn, pt = rec[key]
                if pn < 0 or (pn, pt) in rec:
                    continue
                if (pn, pt) not in referrers:
                    referrers[(pn, pt)] = []
                    need.append((pn, pt))
                referrers[(pn, pt)].append(key)
            if not need:
                break
            frontier = []
            for (pn, pt) in need:
                got = resolve(pn, pt)
                if got is None:
                    # genuinely unavailable: sever so the arc is dropped,
                    # not misattached to the utterance start
                    for key in referrers[(pn, pt)]:
                        rec[key] = (rec[key][0], -1, -2)
                    continue
                rec[(pn, pt)] = got
                frontier.append((pn, pt))
        # resurrection extended/rewrote rec — rebuild the arrays
        ii, tt_, sc, pn_a, pt_a = _rec_arrays()
        n = ii.size
        pk = ii * _PK + (tt_ + 2)
        srt = np.argsort(pk, kind="stable")
        pks = pk[srt]

    lat = Lattice(lmscale=lm_scale, wdpenalty=word_pen)
    start_id = 0
    lat.nodes.append(LNode(id=0, time=0.0, word=NULL_WORD))
    end_id = 1
    lat.nodes.append(
        LNode(id=1, time=T_real * frame_period_s, word=NULL_WORD))
    # nodes in (t, i) order, ids assigned by rank (same order the former
    # sorted() loop produced); node_id lookups become array indexing
    nsort = np.lexsort((ii, tt_))
    nid_a = np.empty(n, np.int64)
    nid_a[nsort] = 2 + np.arange(n, dtype=np.int64)
    node_words = net.node_words
    nodes = lat.nodes
    for nid0, (i_, t_) in enumerate(zip(ii[nsort].tolist(),
                                        tt_[nsort].tolist())):
        nodes.append(LNode(id=nid0 + 2, time=(t_ + 1) * frame_period_s,
                           word=node_words[i_]))
    # arcs: all score/LM arithmetic vectorised over the record arrays,
    # one lean loop only for LArc construction (same arc order and f64
    # arithmetic as the former per-record loop)
    end_exit = np.asarray(net.end_exit, np.float64)
    m_start = pn_a < 0
    m_sever = m_start & (pt_a == -2)
    m_int = ~m_start

    lm_a = np.zeros(n, np.float64)
    ac_a = np.zeros(n, np.float64)
    src_a = np.full(n, start_id, np.int64)
    if m_start.any():
        start_entry = np.asarray(net.start_entry, np.float64)
        lm_a[m_start] = start_entry[ii[m_start]]
        ac_a[m_start] = sc[m_start] - lm_a[m_start] * lm_scale
    if m_int.any():
        pos, _ = _pred_rows(m_int)
        prow = srt[pos]  # every m_int predecessor is present by now
        lm_a[m_int] = _host_lm_lookup(net)(pn_a[m_int], ii[m_int])
        ac_a[m_int] = (sc[m_int] - sc[prow] - lm_a[m_int] * lm_scale
                       - word_pen)
        src_a[m_int] = nid_a[prow]
    m_fin = (tt_ == T_real - 1) & (end_exit[ii] > LSMALL)
    fin_lm = end_exit[ii]

    aid = 0
    arcs = lat.arcs
    for sev_j, fin_j, src_j, nid_j, ac_j, lm_j, flm_j in zip(
            m_sever.tolist(), m_fin.tolist(), src_a.tolist(),
            nid_a.tolist(), ac_a.tolist(), lm_a.tolist(),
            fin_lm.tolist()):
        if not sev_j:
            arcs.append(LArc(id=aid, start=src_j, end=nid_j,
                             aclike=ac_j, lmlike=lm_j))
            aid += 1
        if fin_j:
            arcs.append(LArc(id=aid, start=nid_j, end=end_id,
                             aclike=0.0, lmlike=flm_j))
            aid += 1

    return lat


def generate_lattice_batch(
    net: DecodeNetwork,
    comp: CompiledHMMSet,
    feats_list: List[np.ndarray],
    lm_scale: float = 1.0,
    word_pen: float = 0.0,
    lattice_beam: float = 200.0,
    frame_period_s: float = 0.01,
    precision: str = "highest",
    beam: Optional[float] = None,
    max_active: Optional[int] = None,
    pad_to: int = 128,
    want_results: bool = False,
    *,
    device,
):
    """Batched lattice generation on `device`: a bucket of utterances
    through ONE decode launch (the HVite -z bucket path).

    General networks only: on a uniform-row (LV) net it raises HError
    8527, because the reference's compacted-record LV pipeline
    (`_lv_lattice_pipeline`) is not ported yet. Identical lattices to the
    sequential `generate_lattice` per utterance. `want_results=True`
    returns (lattice, DecodeResult) pairs, the 1-best walked from the
    same planes.
    """
    _refuse_uniform(net, "generate_lattice_batch")
    B = len(feats_list)
    lens = [int(f.shape[0]) for f in feats_list]
    T = ((max(lens) + pad_to - 1) // pad_to) * pad_to
    D = feats_list[0].shape[1]
    fb = np.zeros((B, T, D), np.float32)
    for b, f in enumerate(feats_list):
        fb[b, : lens[b]] = f
    outp = _net_outp(net, comp, fb, precision, device)
    (vb, wnb, wtb), (WEb, pwnb, pwtb) = run_decode_batch(
        outp, net, lm_scale, word_pen, beam=beam, max_active=max_active)
    return lattices_from_planes(
        net, (vb, wnb, wtb), (WEb, pwnb, pwtb), lens, lattice_beam,
        frame_period_s, lm_scale, word_pen, want_results)


def lattices_from_planes(net, carry, planes, lens, lattice_beam,
                         frame_period_s, lm_scale, word_pen,
                         want_results=False):
    """Per-utterance lattices from one padded scan's output: `carry` =
    (v, wn, wt) (B, Ns) and `planes` = (WE, pwn, pwt) (B, T, Nn), as
    `run_decode_batch` returns them, and each utterance's real frame
    count in `lens` (htk_tpu/algo/decode.py : the walk of
    `_generate_lattice_batch_generic`). The plane slices at each
    utterance's own t_real are exactly the unpadded planes."""
    vb, wnb, wtb = (x.cpu().numpy() for x in carry)
    WEb, pwnb, pwtb = (x.cpu().numpy() for x in planes)
    T = WEb.shape[1]
    out = []
    for b, tr in enumerate(lens):
        if tr == T:
            carry_b, fin = (vb[b], wnb[b], wtb[b]), None
        else:
            # ends at time tr-1 were emitted by scan step tr
            carry_b, fin = None, (WEb[b, tr], pwnb[b, tr], pwtb[b, tr])
        r = _lattice_from_host_planes(
            net, WEb[b, :tr], pwnb[b, :tr], pwtb[b, :tr], carry_b, fin,
            tr, lattice_beam, frame_period_s, lm_scale, word_pen,
            want_results)
        out.append((r if isinstance(r, tuple) else (r, None))
                   if want_results else r)
    return out
