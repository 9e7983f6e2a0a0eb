"""A plain reference of the hybrid LSTMP-HMM's acoustic scores, in float64
torch: the projected LSTM with peepholes of Sak, Senior and Beaufays
(Interspeech 2014), one utterance at a time, one frame at a time, the
equations written out. It imports nothing of htk_tpu_torch and no JAX;
callers hand it plain arrays. No kernels, no batching, no kept buffers.

For layer l, with x_t its input, r and c its state (0 before frame 0):

  i_t = sigmoid(W_ix x_t + W_ir r_{t-1} + p_i * c_{t-1} + b_i)
  f_t = sigmoid(W_fx x_t + W_fr r_{t-1} + p_f * c_{t-1} + b_f)
  c_t = f_t * c_{t-1} + i_t * tanh(W_cx x_t + W_cr r_{t-1} + b_c)
  o_t = sigmoid(W_ox x_t + W_or r_{t-1} + p_o * c_t + b_o)
  m_t = o_t * tanh(c_t);   r_t = W_rm m_t      (the layer's output)

then an affine output layer (its outputs the logits), log-softmax, minus
log prior. Frame t of an utterance of T frames scores with the net's
output at step t + d (d the output delay); the steps run over T + d
frames, those past the end repeating the last frame.

Departures from Sak et al.: the output delay's extra steps read the last
frame again (the paper delays the labels in training and says nothing of
the utterance's end); no cell or projection clipping (the paper has
none); the net's input may be a spliced window of frames (`context`,
clamped at the utterance's edges; 0 in the benchmark's net). The gate
matrices are stored stacked, rows i, f, c, o (n_c each).

The matmuls would run with TF32 off on a CUDA card (set below); they are
float64 here, which TF32 does not touch.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=F64)


def lstmp_layer(xs: torch.Tensor, W_x, W_r, peep, b, W_rm) -> torch.Tensor:
    """One LSTMP layer over the frames xs (S, n_in): r (S, n_r)."""
    W_x, W_r, peep, b, W_rm = (_t(a) for a in (W_x, W_r, peep, b, W_rm))
    n = peep.shape[1]
    gate = {g: slice(k * n, (k + 1) * n) for k, g in enumerate("ifco")}
    r = torch.zeros(W_rm.shape[0], dtype=F64)
    c = torch.zeros(n, dtype=F64)
    out = []
    for x in xs:
        def pre(g):
            return W_x[gate[g]] @ x + W_r[gate[g]] @ r + b[gate[g]]
        i = torch.sigmoid(pre("i") + peep[0] * c)
        f = torch.sigmoid(pre("f") + peep[1] * c)
        c = f * c + i * torch.tanh(pre("c"))
        o = torch.sigmoid(pre("o") + peep[2] * c)
        m = o * torch.tanh(c)
        r = W_rm @ m
        out.append(r)
    return torch.stack(out)


def frames_in(feats: np.ndarray, context: int, delay: int) -> torch.Tensor:
    """The net's input at each of the T + delay steps of one utterance
    (T, D): step s reads frames clamp(s + o, 0, T - 1), o in -C..C."""
    x = _t(feats)
    T = x.shape[0]
    idx = [min(max(s + o, 0), T - 1) for s in range(T + delay)
           for o in range(-context, context + 1)]
    return x[torch.as_tensor(idx)].reshape(T + delay, -1)


def hidden(layers: Sequence[tuple], feats: np.ndarray, context: int,
           delay: int) -> torch.Tensor:
    """The input of the output layer at each step (T + delay, width):
    `layers` the hidden layers in order, ("LSTMP", W_x, W_r, peep, b,
    W_rm) or (W, b, activation)."""
    h = frames_in(feats, context, delay)
    for l in layers:
        if l[0] == "LSTMP":
            h = lstmp_layer(h, *l[1:])
        else:
            W, b, act = l
            h = {"SIGMOID": torch.sigmoid, "RELU": torch.relu,
                 "TANH": torch.tanh, "LINEAR": lambda v: v}[act](
                     h @ _t(W).T + _t(b))
    return h


def scores(layers: Sequence[tuple], out_layer: tuple, priors: np.ndarray,
           feats: np.ndarray, context: int = 0,
           delay: int = 0) -> torch.Tensor:
    """(T, K) float64 log posterior minus log prior of one utterance's
    frames (T, D); `out_layer` (W, b), its outputs the logits."""
    h = hidden(layers, feats, context, delay)[delay:]
    z = h @ _t(out_layer[0]).T + _t(out_layer[1])
    return torch.log_softmax(z, dim=-1) - torch.log(_t(priors))[None]


def output_scale(layers: Sequence[tuple], out_layer: tuple,
                 feats: np.ndarray, context: int = 0,
                 delay: int = 0) -> torch.Tensor:
    """(T, K) sum_k |W_jk h_k| of the output layer's dot products, the
    size that float32 rounds them at."""
    h = hidden(layers, feats, context, delay)[delay:]
    return h.abs() @ _t(out_layer[0]).abs().T
