"""The plain reference of the LSTMP hybrid cell's acoustic scores, in
float64 torch: the projected LSTM with peepholes (Sak, Senior and
Beaufays, Interspeech 2014), then an affine output layer whose outputs
are the logits, log-softmax, minus log prior. A copy of the tests' plain
reference (tests/plain_lstmp.py), kept here so that the benchmark's
yardstick does not move when the tests do. It imports nothing of the
program and no JAX; it takes the weights the benchmark generated, as
tensors.

For layer l, with x_t its input and r, c its state (0 before frame 0):

  i_t = sigmoid(W_ix x_t + W_ir r_{t-1} + p_i * c_{t-1} + b_i)
  f_t = sigmoid(W_fx x_t + W_fr r_{t-1} + p_f * c_{t-1} + b_f)
  c_t = f_t * c_{t-1} + i_t * tanh(W_cx x_t + W_cr r_{t-1} + b_c)
  o_t = sigmoid(W_ox x_t + W_or r_{t-1} + p_o * c_t + b_o)
  m_t = o_t * tanh(c_t);   r_t = W_rm m_t

(gate rows stacked i, f, c, o). Frame t of an utterance of T frames
scores with the output at step t + d, over T + d steps whose frames past
the end repeat the last one. The net's input is one frame a step.

Blocked: the utterances of one call step together, each on its own
frames (row b of a step reads frame min(s, T_b - 1) of utterance b and
carries its own state), so that a block of the check's sampled requests
costs one pass of steps; no row reads another. TF32 is off for every
matmul in the process, as a float32 reference on a CUDA card needs
(float64 ones are not touched by it either way).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64


class LSTMP:
    """The net in float64 on `device`: `layers` [(W_x, W_r, peep, b,
    W_rm)], `out` (W (K, n_r), b (K,)), `priors` (K,), `delay` d."""

    def __init__(self, layers: Sequence[tuple], out: tuple,
                 priors: torch.Tensor, delay: int, device):
        def f64(a):
            return a.to(device=device, dtype=F64)

        self.layers = [tuple(f64(a) for a in l) for l in layers]
        self.W, self.b = (f64(a) for a in out)
        self.log_prior = torch.log(f64(priors))
        self.delay = delay
        self.device = device

    def _layer(self, xs: torch.Tensor, W_x, W_r, peep, b,
               W_rm) -> torch.Tensor:
        """xs (S, U, n_in) -> r (S, U, n_r), U utterances side by side."""
        n = peep.shape[1]
        gi, gf, gc, go = (slice(k * n, (k + 1) * n) for k in range(4))
        pre_x = xs @ W_x.T + b  # W_x x_t + b, every step at once
        U = xs.shape[1]
        r = xs.new_zeros((U, W_rm.shape[0]))
        c = xs.new_zeros((U, n))
        out = []
        for s in range(xs.shape[0]):
            z = pre_x[s] + r @ W_r.T
            i = torch.sigmoid(z[:, gi] + peep[0] * c)
            f = torch.sigmoid(z[:, gf] + peep[1] * c)
            c = f * c + i * torch.tanh(z[:, gc])
            o = torch.sigmoid(z[:, go] + peep[2] * c)
            r = (o * torch.tanh(c)) @ W_rm.T
            out.append(r)
        return torch.stack(out)

    def run(self, feats_list) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Each utterance's (scores (T_b, K), h (T_b, n_r)): log posterior
        minus log prior, and the output layer's input."""
        xs = [torch.as_tensor(f, device=self.device).to(F64)
              for f in feats_list]
        lens = [x.shape[0] for x in xs]
        S = max(lens) + self.delay
        steps = torch.arange(S, device=self.device)
        h = torch.stack([x[steps.clamp(max=n - 1)] for x, n in
                         zip(xs, lens)], dim=1)  # (S, U, D)
        for l in self.layers:
            h = self._layer(h, *l)
        out = []
        for u, n in enumerate(lens):
            hu = h[self.delay:self.delay + n, u]
            z = hu @ self.W.T + self.b
            out.append((torch.log_softmax(z, dim=-1) - self.log_prior, hu))
        return out

    def scale(self, h: torch.Tensor) -> torch.Tensor:
        """sum_k |W_jk h_k| of the output layer's dot products at the rows
        h (n, n_r): the size that float32 rounds them at (n, K)."""
        return h.abs() @ self.W.abs().T
