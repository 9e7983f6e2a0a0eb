"""Streaming token-passing decode (HVite live mode / HRec frame API).

The PyTorch counterpart of `htk_tpu/algo/stream_decode.py`.
`HTKLib/HRec.c` is streaming by nature: StartRecognition(), one
ProcessObservation() per frame as HParm's live buffer produces it, then
CompleteRecognition(). Batch decoding (algo/decode.py) runs the recursion
over a whole utterance in one `ops/decode_scan.decode_scan` launch; this
module cuts it into chunks of F frames (default 32, ~0.3 s of audio) and
carries the recursion's state (v, wn, wt) from one chunk to the next on
the device. Each chunk costs

  - OutP of its frames (`decode._net_outp`, the set's GaussianScorer), or
    in `state_mode` a gather of the caller's physical-state scores;
  - one decode_scan launch (the CUDA kernel on the card, its plain
    version on the CPU) from the carried state at the chunk's global
    frame index, on the operands batch decoding builds
    (`decode.decode_operands`: LM-scaled transitions and start entry,
    per-node word penalty);
  - one copy of the chunk's (F, Nn) word-end record planes to the host.

The reference pads a short final chunk and masks its padded frames, so
that one compiled program serves the stream. The port launches the short
chunk at its own frame count instead (nothing is compiled per shape);
both give the same records. Chunked output is bit for bit
the batch decoder's on the same frames, since every frame runs the same
update in the same order.

partial_result() gives HTK's live-mode partial traceback: the best word
sequence ending at the latest processed frame. As in the reference it
walks every record plane kept so far on each call.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models.hmmset import CompiledHMMSet
from ..ops.decode_scan import decode_scan
from ..utils.errors import HError
from .decode import (DecodeResult, _final_records, _finalize, _net_dev,
                     _net_outp, decode_operands)
from .net import DecodeNetwork


class StreamingDecoder:
    """Incremental Viterbi over a compiled word network on `device`.

    feed(feats) accepts any number of frames; flush() finalises and
    returns the DecodeResult (None if no complete path). The carry lives
    on the device between chunks; only the (F, Nn) record planes come
    back per chunk.
    """

    def __init__(self, net: DecodeNetwork, comp: Optional[CompiledHMMSet],
                 lm_scale: float = 1.0, word_pen: float = 0.0,
                 chunk: int = 32, precision: str = "highest",
                 state_mode: bool = False, *, device):
        """state_mode: feed() receives per-frame PHYSICAL-state scores
        (e.g. streaming ANN log posterior/prior, the hybrid hook)
        instead of feature frames."""
        if net.uniform_width:
            HError(8521, "StreamingDecoder: live mode targets HVite "
                         "networks (HDecode's LV path is batch two-pass)")
        self.state_mode = bool(state_mode)
        self.net = net
        self.comp = comp
        self.lm_scale = float(lm_scale)
        self.word_pen = float(word_pen)
        self.chunk = int(chunk)
        self.precision = precision
        self.device = torch.device(device)
        Ns = len(net.comp_state)
        self._ops = decode_operands(
            torch.empty((1, 0, Ns), device=self.device), net,
            self.lm_scale, self.word_pen)[1:]
        self._carry = None  # (v, wn, wt), each (1, Ns); None before frame 0
        self._buf: Optional[np.ndarray] = None  # pending feature frames
        self._t = 0  # frames fully processed
        self._WEs: List[np.ndarray] = []
        self._pwns: List[np.ndarray] = []
        self._pwts: List[np.ndarray] = []
        self._done = False

    # -- internals -------------------------------------------------------

    def _outp(self, feats: np.ndarray) -> torch.Tensor:
        """(1, F, Ns) network-state scores of a chunk on the device."""
        if self.state_mode:
            x = torch.as_tensor(np.asarray(feats, np.float32),
                                device=self.device)
            cs = _net_dev(self.net, self.device)["comp_state"]
            return x[:, cs][None].contiguous()
        return _net_outp(self.net, self.comp, feats[None], self.precision,
                         self.device)

    def _launch(self, outp: torch.Tensor):
        """One decode_scan launch from the carried state; keeps the new
        carry and returns the chunk's (3, F, Nn) records on the device,
        the word ends as their int32 bits."""
        self._carry, (WE, pwn, pwt) = decode_scan(
            outp, *self._ops, init=self._carry, t0=self._t)
        return torch.stack([WE[0].view(torch.int32), pwn[0], pwt[0]])

    def _keep(self, recs: torch.Tensor) -> None:
        """The chunk's records to the host, in one copy."""
        r = recs.cpu().numpy()
        self._WEs.append(r[0].view(np.float32))
        self._pwns.append(r[1])
        self._pwts.append(r[2])

    def _process(self, feats: np.ndarray) -> None:
        self._keep(self._launch(self._outp(feats)))
        self._t += feats.shape[0]

    def _result(self) -> Optional[DecodeResult]:
        v, wn, wt = (x[0].cpu().numpy() for x in self._carry)
        WE_fin, pwn_fin, pwt_fin = _final_records(self.net, v, wn, wt)
        WEs, pwns, pwts = (np.concatenate(p, axis=0) for p in
                           (self._WEs, self._pwns, self._pwts))
        return _finalize(self.net, WEs, pwns, pwts, WE_fin, pwn_fin,
                         pwt_fin, self._t, self.lm_scale)

    # -- public API ------------------------------------------------------

    def feed(self, feats: np.ndarray) -> None:
        if self._done:
            HError(8522, "StreamingDecoder: feed() after flush()")
        feats = np.asarray(feats, np.float32)
        if feats.size == 0:
            return
        self._buf = feats if self._buf is None else \
            np.concatenate([self._buf, feats], axis=0)
        while self._buf.shape[0] >= self.chunk:
            self._process(self._buf[: self.chunk])
            self._buf = self._buf[self.chunk:]

    def partial_result(self) -> Optional[DecodeResult]:
        """Best word sequence ending at the latest processed frame
        (HTK live mode's partial traceback). Pending buffered frames
        (< one chunk) are not included."""
        if self._t == 0:
            return None
        return self._result()

    def flush(self) -> Optional[DecodeResult]:
        if self._done:
            HError(8522, "StreamingDecoder: flush() twice")
        self._done = True
        if self._buf is not None and self._buf.shape[0] > 0:
            self._process(self._buf)
            self._buf = None
        if self._t == 0:
            return None
        return self._result()

    @property
    def frames_processed(self) -> int:
        return self._t
