"""Device-side composite-HMM assembly, batched, in torch.

The PyTorch counterpart of `htk_tpu/algo/composite_device.py`: builds the
dense composite arrays (logA/a0/aE/comp_state/masks/transition segment
maps) on the device from just each utterance's model-id sequence, so the
host ships about K int32s per utterance instead of padded (Q, Q) planes.
The JAX package vmaps a per-utterance function; here the batch dimension
is written out.

Semantics match algo/composite.build_composite exactly, including tee
chains: a block k links to any later block k2 when every intermediate
model is a tee, with the chain's entry->exit log-probs added; validity is
vectorised via a cumulative non-tee count, the chain weight via
cumulative tee log-prob sums.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.hmmset import CompiledHMMSet
from ..utils.logmath import LSMALL, LZERO


class Assembler:
    """Batched device assembler closed over a compiled HMM set's tables.

    Calling it on (B, K) model ids (-1 padded) gives a dict of
    (B, Q = K * emax) arrays, as `assemble_utterance` of the JAX package
    gives per utterance."""

    def __init__(self, comp: CompiledHMMSet, device):
        emax = comp.nmax - 2
        self.emax, self.nmax, self.n_states = emax, comp.nmax, comp.n_states

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        # a trash row appended for id -1
        self.model_states = dev(np.concatenate(
            [comp.model_states, np.full((1, emax), -1, np.int32)]),
            torch.int64)
        self.model_transp = dev(np.concatenate(
            [comp.model_transp, np.zeros(1, np.int32)]), torch.int64)
        self.model_nstates = dev(np.concatenate(
            [comp.model_nstates, np.full(1, 2, np.int32)]), torch.int64)
        self.log_transp = dev(comp.log_transp, torch.float32)

    def __call__(self, ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        emax, nmax, n_states = self.emax, self.nmax, self.n_states
        dev = ids.device
        B, K = ids.shape
        Q = K * emax
        ids = ids.long()
        valid_k = ids >= 0
        safe = torch.where(valid_k, ids, self.model_states.shape[0] - 1)

        tid = self.model_transp[safe]  # (B, K)
        lt = self.log_transp[tid]  # (B, K, nmax, nmax)
        n_k = self.model_nstates[safe]

        # per-block pieces; exit column and tee prob at column n_k-1
        en = lt[:, :, 0, 1:1 + emax]  # (B, K, emax)
        within = lt[:, :, 1:1 + emax, 1:1 + emax]  # (B, K, emax, emax)
        exit_col = (n_k - 1).clamp(0, nmax - 1)
        ex = torch.gather(lt[:, :, 1:1 + emax, :], 3,
                          exit_col[:, :, None, None].expand(B, K, emax, 1)
                          )[..., 0]  # (B, K, emax)
        tee = torch.gather(lt[:, :, 0, :], 2, exit_col[..., None])[..., 0]
        vk = valid_k[..., None]
        en = torch.where(vk, en, LZERO)
        ex = torch.where(vk, ex, LZERO)
        within = torch.where(vk[..., None], within, LZERO)
        tee = torch.where(valid_k, tee, LZERO)

        # composite states + mask
        st = self.model_states[safe]  # (B, K, emax), -1 for dead slots
        comp_state = torch.where((st >= 0) & vk, st, n_states)
        q_mask = (comp_state < n_states).reshape(B, Q)
        comp_state = comp_state.reshape(B, Q)

        # within-block logA on the block diagonal of a (B, K, e, K, e) view
        kk = torch.arange(K, device=dev)
        logA = torch.full((B, K, emax, K, emax), LZERO, dtype=torch.float32,
                          device=dev)
        logA[:, kk, :, kk, :] = within.permute(1, 0, 2, 3)

        # tee chains: valid k->k2 iff no non-tee strictly between them
        is_tee = tee > LSMALL
        has_states = valid_k & (st >= 0).any(dim=2)
        nontee_step = (~is_tee) & valid_k
        nontee = torch.cumsum(nontee_step.long(), dim=1)  # incl. position
        cumtee = torch.cumsum(torch.where(is_tee, tee, 0.0), dim=1)
        # chain(k, k2) = cumtee[k2-1] - cumtee[k]; valid needs all of
        # k+1..k2-1 tee: nontee[k2-1] == nontee[k]
        k2m1 = (kk - 1).clamp(min=0)
        chain_w = cumtee[:, k2m1][:, None, :] - cumtee[:, :, None]  # (B,K,K2)
        chain_ok = (nontee[:, k2m1][:, None, :] - nontee[:, :, None]) == 0
        pair_ok = ((kk[None, :] > kk[:, None])[None] & chain_ok
                   & has_states[:, :, None] & has_states[:, None, :])
        cross = torch.where(
            pair_ok[..., None, None],
            ex[:, :, None, :, None] + chain_w[..., None, None]
            + en[:, None, :, None, :],
            LZERO)  # (B, K, K2, emax_src, emax_dst)
        logA = torch.maximum(logA, cross.permute(0, 1, 3, 2, 4))
        logA = logA.reshape(B, Q, Q)

        # utterance entry/exit through leading/trailing tee chains
        lead_ok = (nontee - nontee_step.long()) == 0
        lead_chain = cumtee - torch.where(is_tee, tee, 0.0)
        a0 = torch.where((lead_ok & has_states)[..., None],
                         lead_chain[..., None] + en, LZERO).reshape(B, Q)
        trail_ok = (nontee[:, -1:] - nontee) == 0
        trail_chain = cumtee[:, -1:] - cumtee
        aE = torch.where((trail_ok & has_states)[..., None],
                         ex + trail_chain[..., None], LZERO).reshape(B, Q)

        # transition accumulator segment maps
        i_loc = torch.arange(emax, device=dev)
        tr_seg = ((tid[..., None, None] * nmax + (1 + i_loc)[:, None]) * nmax
                  + (1 + i_loc)[None, :])  # (B, K, emax, emax)
        tr_full = torch.full((B, K, emax, K, emax), -1, dtype=torch.int32,
                             device=dev)
        tr_full[:, kk, :, kk, :] = torch.where(
            vk[..., None], tr_seg, -1).to(torch.int32).permute(1, 0, 2, 3)
        entry_seg = torch.where(
            vk, tid[..., None] * nmax * nmax + (1 + i_loc), -1
        ).reshape(B, Q).to(torch.int32)
        exit_seg = torch.where(
            vk, (tid[..., None] * nmax + (1 + i_loc)) * nmax
            + exit_col[..., None], -1).reshape(B, Q).to(torch.int32)
        # dead slots (st < 0) carry no accumulation
        dead = ~q_mask
        entry_seg = torch.where(dead, -1, entry_seg)
        exit_seg = torch.where(dead, -1, exit_seg)

        return dict(comp_state=comp_state.to(torch.int32), q_mask=q_mask,
                    logA=logA, a0=a0, aE=aE,
                    tr_seg=tr_full.reshape(B, Q, Q), entry_seg=entry_seg,
                    exit_seg=exit_seg)


def make_assembler(comp: CompiledHMMSet, *, device) -> Assembler:
    """Batched device assembler closed over a compiled HMM set's tables."""
    return Assembler(comp, device)
