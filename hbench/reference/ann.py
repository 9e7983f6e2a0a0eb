"""The plain reference of the hybrid cell's DNN, in float64 torch: FeaMix
splicing with the utterance's edge frames replicated, the layers
(h = act(h @ W^T + b)), the last layer's outputs as logits, log-softmax,
minus log prior. A copy of the DNN part of the tests' plain reference
(tests/plain_hybrid.py), kept here so that the benchmark's yardstick does
not move when the tests do. It imports nothing of the program and no JAX;
it takes the weights the benchmark generated, as tensors.

Frames run in blocks, so that the activations of a long utterance fit
beside the check. TF32 is off for every matmul in the process, as a
float32 reference on a CUDA card needs (float64 ones are not touched by
it either way).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64
BLOCK = 4096  # frames a block
ACTS = {"SIGMOID": torch.sigmoid, "RELU": torch.relu, "TANH": torch.tanh,
        "LINEAR": lambda v: v}


class DNN:
    """The layers in float64 on `device`: `layers` [(W (out, in), b (out,),
    activation)], the last one's activation ignored (its outputs are the
    logits); `priors` (K,)."""

    def __init__(self, layers: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                              str]],
                 priors: torch.Tensor, context: int, device):
        self.W = [w.to(device=device, dtype=F64) for w, _, _ in layers]
        self.b = [b.to(device=device, dtype=F64) for _, b, _ in layers]
        self.acts = [a for _, _, a in layers]
        self.log_prior = torch.log(priors.to(device=device, dtype=F64))
        self.context = context
        self.device = device

    def _spliced(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The spliced inputs of frames t of one utterance x (T, D)."""
        T = x.shape[0]
        offs = torch.arange(-self.context, self.context + 1,
                            device=x.device)
        idx = (t[:, None] + offs[None]).clamp(0, T - 1)
        return x[idx].reshape(len(t), -1)

    def _last_hidden(self, h: torch.Tensor) -> torch.Tensor:
        for W, b, act in zip(self.W[:-1], self.b[:-1], self.acts[:-1]):
            h = ACTS[act](h @ W.T + b)
        return h

    def scores(self, feats) -> torch.Tensor:
        """(T, K) float64 log posterior minus log prior of one utterance's
        frames (T, D)."""
        x = torch.as_tensor(feats, device=self.device).to(F64)
        T = x.shape[0]
        out: List[torch.Tensor] = []
        for t0 in range(0, T, BLOCK):
            t = torch.arange(t0, min(T, t0 + BLOCK), device=self.device)
            h = self._last_hidden(self._spliced(x, t))
            z = h @ self.W[-1].T + self.b[-1]
            out.append(torch.log_softmax(z, dim=-1) - self.log_prior)
        return torch.cat(out)

    def rows(self, feats, frames) -> Tuple[torch.Tensor, torch.Tensor]:
        """The scores of the given frames of one utterance (n, K), and the
        scale of each output's dot product, sum_k |W_jk h_k| over the last
        hidden layer's h (n, K)."""
        x = torch.as_tensor(feats, device=self.device).to(F64)
        t = torch.as_tensor(frames, device=self.device)
        h = self._last_hidden(self._spliced(x, t))
        z = h @ self.W[-1].T + self.b[-1]
        return (torch.log_softmax(z, dim=-1) - self.log_prior,
                h.abs() @ self.W[-1].abs().T)
