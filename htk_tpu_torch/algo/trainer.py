"""Training orchestration: utterance prep, bucketing, batched FB steps.

The PyTorch counterpart of `htk_tpu/algo/trainer.py`, the role HERest.c's
main loop plays: utterances are bucketed to a small set of (T, Q) pad
shapes, batched, and each batch runs one `fb_batch` call on the device.
Accumulators sum across batches on the device; per-batch logP stays there
too until the end of a pass, so the host pads the next batch while the
device works on the current one.

`Trainer` takes host-built composites (algo/composite.py);
`DeviceCompositeTrainer`, HERest's default, ships only model ids and
assembles the composites on the device (algo/composite_device.py). Not
ported yet: the second channel of single-pass retraining (-r) and the
multi-device trainer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.hmmset import CompiledHMMSet
from ..utils.errors import HError, HRError
from ..utils.logmath import LZERO
from .composite import CompositeHMM, build_composite
from .composite_device import make_assembler
from .fb import Accumulators, fb_batch, zero_accs


@dataclass
class UttData:
    """One prepared utterance (host arrays, unpadded)."""

    name: str
    feats: np.ndarray  # (T, D) f32
    hmm: CompositeHMM


def prepare_utterance(comp: CompiledHMMSet, name: str, feats: np.ndarray,
                      model_names: Sequence[str]) -> UttData:
    ids = [comp.model_id(m) for m in model_names]
    return UttData(name=name, feats=np.asarray(feats, np.float32),
                   hmm=build_composite(comp, ids))


def _bucket(n: int, base: int = 32) -> int:
    b = base
    while b < n:
        b = b * 2 if b < 512 else b + 256
    return b


def make_batches(utts: Sequence[UttData],
                 batch_size: int = 8) -> List[List[UttData]]:
    """Group utterances into batches of similar padded shape."""
    buckets: Dict[Tuple[int, int], List[UttData]] = {}
    for u in utts:
        key = (_bucket(u.feats.shape[0]), _bucket(u.hmm.n_states, 16))
        buckets.setdefault(key, []).append(u)
    batches = []
    for key in sorted(buckets):
        us = buckets[key]
        for i in range(0, len(us), batch_size):
            batches.append(us[i:i + batch_size])
    return batches


def pad_batch(batch: Sequence[UttData], n_states_phys: int):
    """Pad a batch to common (B, T, Q) numpy arrays for fb_batch."""
    B = len(batch)
    T = _bucket(max(u.feats.shape[0] for u in batch))
    Q = _bucket(max(u.hmm.n_states for u in batch), 16)
    D = batch[0].feats.shape[1]

    feats = np.zeros((B, T, D), np.float32)
    t_real = np.zeros(B, np.int32)
    comp_state = np.full((B, Q), n_states_phys, np.int32)  # trash state id
    q_mask = np.zeros((B, Q), bool)
    logA = np.full((B, Q, Q), LZERO, np.float32)
    a0 = np.full((B, Q), LZERO, np.float32)
    aE = np.full((B, Q), LZERO, np.float32)
    tr_seg = np.full((B, Q, Q), -1, np.int32)
    entry_seg = np.full((B, Q), -1, np.int32)
    exit_seg = np.full((B, Q), -1, np.int32)
    for b, u in enumerate(batch):
        t = u.feats.shape[0]
        q = u.hmm.n_states
        feats[b, :t] = u.feats
        t_real[b] = t
        comp_state[b, :q] = np.minimum(u.hmm.comp_state, n_states_phys)
        q_mask[b, :q] = True
        logA[b, :q, :q] = u.hmm.logA
        a0[b, :q] = u.hmm.a0
        aE[b, :q] = u.hmm.aE
        tr_seg[b, :q, :q] = u.hmm.tr_seg
        entry_seg[b, :q] = u.hmm.entry_seg
        exit_seg[b, :q] = u.hmm.exit_seg
    return dict(feats=feats, t_real=t_real, comp_state=comp_state,
                q_mask=q_mask, logA=logA, a0=a0, aE=aE, tr_seg=tr_seg,
                entry_seg=entry_seg, exit_seg=exit_seg)


@dataclass
class UttIds:
    """Lightweight utterance for the device-composite path."""

    name: str
    feats: np.ndarray  # (T, D) f32
    ids: np.ndarray  # (K,) int32 model ids


def prepare_utterance_ids(comp, name, feats, model_names) -> UttIds:
    ids = np.asarray([comp.model_id(m) for m in model_names], np.int32)
    return UttIds(name=name, feats=np.asarray(feats, np.float32), ids=ids)


class Trainer:
    """Runs embedded-reestimation accumulation over a corpus on `device`."""

    def __init__(self, comp: CompiledHMMSet, precision: str = "highest",
                 prune: Optional[Tuple[float, float, float]] = None, *,
                 device):
        if getattr(comp, "full_cov", False):
            HError(7060, "Trainer: full-covariance sets are decode/align-"
                         "only — train with DIAGC models")
        self.comp = comp
        self.precision = precision
        self.device = torch.device(device)
        # HERest -t f [i l]: beta-beam pruning with retry escalation — an
        # utterance whose pruned FB finds no path re-runs with the beam
        # widened by `inc` up to `lim` (HFB.c pruneSetting). The beam is an
        # argument of the scans, so escalation rebuilds nothing.
        self.prune = prune
        self.tr_flat = int(np.prod(comp.log_transp.shape))

    def params(self) -> dict:
        """The set's parameters as device tensors, the state tables with
        one trash row appended for padded composite states."""
        c = self.comp
        sw = (c.state_sw if c.state_sw is not None
              else np.ones_like(c.state_logw))
        pads = dict(
            state_mix=(c.state_mix, np.full((1, c.max_mix), -1, np.int32)),
            state_logw=(c.state_logw,
                        np.full((1, c.max_mix), LZERO, np.float32)),
            state_sw=(sw, np.ones((1, c.max_mix), np.float32)))

        def dev(a):
            return torch.as_tensor(np.asarray(a), device=self.device)

        p = {k: dev(np.concatenate(v, axis=0)) for k, v in pads.items()}
        p["state_mix"] = p["state_mix"].long()
        p.update(means=dev(np.asarray(c.means, np.float32)),
                 variances=dev(np.asarray(c.variances, np.float32)),
                 gconsts=dev(np.asarray(c.gconsts, np.float32)))
        return p

    def _zero(self) -> Accumulators:
        c = self.comp
        return zero_accs(c.n_mix, c.dim, c.n_states, c.max_mix, self.tr_flat,
                         device=self.device)

    def _fb(self, params, arrs, beam):
        """One fb_batch call on device tensors `arrs`."""
        return fb_batch(
            arrs["feats"], arrs["t_real"], arrs["comp_state"],
            arrs["q_mask"], arrs["logA"], arrs["a0"], arrs["aE"],
            arrs["tr_seg"], arrs["entry_seg"], arrs["exit_seg"],
            **params, slot_blocks=tuple(self.comp.slot_blocks) or None,
            n_states=self.comp.n_states, tr_flat=self.tr_flat,
            precision=self.precision, beam=beam)

    def batches(self, utts, batch_size):
        """(batch, device arrays) for each padded batch of `utts`."""
        for batch in make_batches(utts, batch_size):
            arrs = pad_batch(batch, self.comp.n_states)
            yield batch, {k: torch.as_tensor(v, device=self.device)
                          for k, v in arrs.items()}

    def _run_pass(self, utts, batch_size, params, total, beam):
        """One pass over `utts`; adds into `total` in place and returns
        [(utt, logP)]."""
        pending = []
        for batch, arrs in self.batches(utts, batch_size):
            logps, accs = self._fb(params, arrs, beam)
            for a, b in zip(total, accs):
                a.add_(b)
            pending.append((batch, logps))
        flat = []
        for batch, logps in pending:
            lp = logps.cpu().numpy()
            flat.extend(zip(batch, lp[:len(batch)]))
        return flat

    def accumulate(self, utts: Sequence, batch_size: int = 8,
                   trace: int = 0) -> Accumulators:
        """One full pass over the corpus; returns summed Accumulators.

        With pruning enabled, failed utterances (no surviving path)
        contribute zero accumulators on the first pass and re-run with the
        beam escalated by `inc` up to `lim` before being skipped — the
        HERest -t f i l retry ladder.
        """
        total = self._zero()
        params = self.params()
        beam = self.prune[0] if self.prune else None
        results = self._run_pass(utts, batch_size, params, total, beam)
        failed = []
        for u, l in results:
            if l <= LZERO / 2:
                failed.append(u)
            elif trace >= 2:
                print(f"  {u.name}: logP={l:.2f} "
                      f"({l / u.feats.shape[0]:.3f}/frame)")
        if self.prune is not None and failed:
            _f, inc, lim = self.prune
            while failed and inc > 0 and beam + inc <= lim + 1e-6:
                beam += inc
                if trace:
                    print(f"accumulate: retrying {len(failed)} utterance(s)"
                          f" at beam {beam:.1f}")
                results = self._run_pass(failed, batch_size, params, total,
                                         beam)
                failed = [u for u, l in results if l <= LZERO / 2]
        for u in failed:
            HRError(7323, "accumulate: no path through utterance %s", u.name)
        if failed:
            HRError(7324, "accumulate: %d utterance(s) skipped", len(failed))
        return total


class DeviceCompositeTrainer(Trainer):
    """Trainer that assembles composite HMMs on the device.

    Per-utterance host work and transfer shrink to the feature matrix plus
    a model-id vector."""

    def __init__(self, comp: CompiledHMMSet, precision: str = "highest",
                 prune: Optional[Tuple[float, float, float]] = None, *,
                 device):
        super().__init__(comp, precision=precision, prune=prune,
                         device=device)
        self._assembler = make_assembler(comp, device=self.device)

    def batches(self, utts, batch_size):
        c = self.comp
        # bucket by (T, K) pads
        buckets: Dict[Tuple[int, int], List[UttIds]] = {}
        for u in utts:
            key = (_bucket(u.feats.shape[0]), _bucket(len(u.ids), 8))
            buckets.setdefault(key, []).append(u)
        for (Tp, Kp) in sorted(buckets):
            us = buckets[(Tp, Kp)]
            for i in range(0, len(us), batch_size):
                batch = us[i:i + batch_size]
                B = len(batch)
                feats = np.zeros((B, Tp, c.dim), np.float32)
                t_real = np.zeros(B, np.int32)
                ids = np.full((B, Kp), -1, np.int32)
                for b, u in enumerate(batch):
                    feats[b, :u.feats.shape[0]] = u.feats
                    t_real[b] = u.feats.shape[0]
                    ids[b, :len(u.ids)] = u.ids
                arrs = self._assembler(torch.as_tensor(ids,
                                                       device=self.device))
                arrs["feats"] = torch.as_tensor(feats, device=self.device)
                arrs["t_real"] = torch.as_tensor(t_real, device=self.device)
                yield batch, arrs
