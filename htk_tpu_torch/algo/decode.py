"""Word-network Viterbi decoding (the HRec token-passing core) in torch.

The PyTorch counterpart of the general-network half of
`htk_tpu/algo/decode.py`. Per frame, over the whole network:

  1. word-end scores   WE[i]   = segment-max of (v + aE) per word node
  2. cross-word step   entry[j] = max_i WE[i] + s*lm[i,j] + p
  3. within-word step  K shifted adds over the banded transition matrix
  4. combine + emit    v'[s] = max(within, entry) + outp[t, s]

The recursion runs in `ops/decode_scan.decode_scan`: the hand-written
CUDA kernel on the card, its plain torch version on the CPU. Word-link
records come back as per-frame (T, Nn) planes that host code walks
backwards for the 1-best transcription (`_finalize`, numpy, unchanged
from the JAX package).

Observation likelihoods come from one batched OutP over physical states
(ops/outp.GaussianScorer); network states gather rows (`comp_state`).

Networks with `uniform_width` (the LV decoder, algo/lvnet in htk_tpu) are
not ported yet and raise HError 8527.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.hmmset import CompiledHMMSet
from ..ops.decode_scan import decode_scan
from ..ops.outp import GaussianScorer
from ..utils.errors import HError
from ..utils.logmath import LZERO, LSMALL
from .net import DecodeNetwork


@dataclass
class DecodeResult:
    words: List[str]  # output word sequence (suppressed symbols removed)
    word_nodes: List[int]  # node index per word
    times: List[Tuple[int, int]]  # (start_frame, end_frame) inclusive
    score: float  # total log likelihood (acoustic + scaled LM)
    scores: List[float]  # per-word segment scores


def _check_general(net: DecodeNetwork) -> None:
    if net.uniform_width:
        HError(8527, "decode: uniform-row (LV) networks are not yet ported "
                     "to htk_tpu_torch; use a general word network (-w)")


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
        }
        caches[str(device)] = d
    return d


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


def run_decode_batch(
    outp_states: torch.Tensor,  # (B, T, Ns), on the decode device
    net: DecodeNetwork,
    lm_scale: float,
    word_pen: float,
    beam: Optional[float] = None,
    max_active: Optional[int] = None,
):
    """Run the decode recursion on the device `outp_states` lies on;
    returns ((v, wn, wt), (WE, pwn, pwt)) as `decode_scan` does.

    `beam`/`max_active` are accepted for the caller's retry ladder and,
    as in the reference's general-network branch, not read."""
    _check_general(net)
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
    survives."""
    _check_general(net)
    T = feats.shape[0]
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
    """Decode a batch of utterances through ONE decode launch on `device`.

    Utterances are zero-padded to a common frame count rounded up to
    `pad_to`. Padding never affects results: the recursion is causal and
    each utterance finalises from the word-end plane at its own t_real
    (WEs[t] holds the ends at time t-1). Identical output to `decode`
    per utterance.
    """
    _check_general(net)
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
