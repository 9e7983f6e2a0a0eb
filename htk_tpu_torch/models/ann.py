"""Feed-forward ANN definitions (HTK v3.5 HANNet), in torch.

The PyTorch counterpart of `htk_tpu/models/ann.py` (`HTKLib/HANNet.c`):
layered feed-forward networks (~L layer macros, ~N network macro) with
affine + activation layers and a feature-mix context window (FeaMix:
splicing +/-C frames), used for hybrid decoding (log posterior - log
prior replaces GMM OutP).

`ANNDef`, `init_ann` (numpy `default_rng(seed)`, so both packages start
from the same weights) and the text file I/O (`save_ann`, `load_ann`)
are copied. `splice` and `forward` are torch; `ANNModule` is an
`nn.Module` built from an ANNDef, and `ann_params` lists its (W, b)
tensors on a device.

Storage uses HTK-style macro syntax inside an MMF-like text file:

  ~N "dnn1"
  <NUMLAYERS> 3 <CONTEXT> 4
  <LAYER> 1 <NUMUNITS> 512 <ACTIVATION> SIGMOID
  <WEIGHT> 512 360   ...rows...
  <BIAS> 512  ...
  ...
  <TARGETPRIORS> K  ...
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..utils.errors import HError

ACTIVATIONS = ("SIGMOID", "RELU", "TANH", "SOFTMAX", "LINEAR")


@dataclass
class Layer:
    weight: np.ndarray  # (out, in)
    bias: np.ndarray  # (out,)
    activation: str = "SIGMOID"


@dataclass
class ANNDef:
    name: str
    layers: List[Layer] = field(default_factory=list)
    context: int = 4  # FeaMix splice window: +/- context frames
    target_priors: Optional[np.ndarray] = None  # (K,) state priors
    target_names: Optional[List[str]] = None  # tied-state macro names

    @property
    def in_dim(self) -> int:
        return self.layers[0].weight.shape[1]

    @property
    def out_dim(self) -> int:
        return self.layers[-1].weight.shape[0]


def splice(feats: torch.Tensor, context: int,
           lengths=None) -> torch.Tensor:
    """(T, D) -> (T, (2c+1)*D) context-window splicing (FeaMix); the
    window clamps at the utterance's edges. A padded batch (B, T, D) with
    its real `lengths` (B,) gives (B, T, (2c+1)*D): frame t of utterance
    b reads frames clamp(t + o, 0, lengths[b] - 1), so the window clamps
    at each utterance's own last frame, and the padded rows repeat it."""
    if context == 0:
        return feats
    T = feats.shape[-2]
    dev = feats.device
    offs = torch.arange(-context, context + 1, device=dev)
    win = torch.arange(T, device=dev)[:, None] + offs[None, :]
    if feats.dim() == 2:
        return feats[win.clamp(0, T - 1)].reshape(T, -1)
    if lengths is None:
        lengths = [T] * feats.shape[0]
    last = torch.as_tensor(np.maximum(np.asarray(lengths, np.int64), 1) - 1,
                           device=dev)
    idx = torch.minimum(win[None].clamp(min=0), last[:, None, None])
    rows = torch.arange(feats.shape[0], device=dev)[:, None, None]
    return feats[rows, idx].reshape(feats.shape[0], T, -1)


def _act(x, kind: str):
    if kind == "SIGMOID":
        return torch.sigmoid(x)
    if kind == "RELU":
        return torch.relu(x)
    if kind == "TANH":
        return torch.tanh(x)
    if kind == "SOFTMAX":
        return torch.softmax(x, dim=-1)
    if kind == "LINEAR":
        return x
    HError(7710, "ANN: unknown activation %s", kind)


def forward(params, activations: List[str], x: torch.Tensor,
            return_logits: bool = True) -> torch.Tensor:
    """MLP forward (HANNet.c ForwardProp). params = [(W, b), ...]."""
    h = x
    for i, ((W, b), act) in enumerate(zip(params, activations)):
        h = h @ W.T + b
        if i == len(params) - 1 and act == "SOFTMAX" and return_logits:
            return h  # pre-softmax logits for CE / hybrid log-posteriors
        h = _act(h, act)
    return h


def ann_params(ann: ANNDef, device="cpu"):
    """The ANN's [(W, b), ...] as float32 tensors on `device` (copies:
    updating them leaves `ann` as it is)."""
    return [(torch.tensor(np.asarray(l.weight, np.float32), device=device),
             torch.tensor(np.asarray(l.bias, np.float32), device=device))
            for l in ann.layers]


class ANNModule(nn.Module):
    """An ANNDef as an `nn.Module` on `device`: its parameters are the
    layers' W, b, W, b, ... in order; forward(x) gives `forward`'s
    output (pre-softmax logits of a SOFTMAX output layer)."""

    def __init__(self, ann: ANNDef, device="cpu"):
        super().__init__()
        self.acts = [l.activation for l in ann.layers]
        self.flat = nn.ParameterList(
            [nn.Parameter(t) for pair in ann_params(ann, device)
             for t in pair])

    def params(self):
        """[(W, b), ...] of the layers."""
        return list(zip(self.flat[0::2], self.flat[1::2]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return forward(self.params(), self.acts, x, return_logits=True)

    def write_back(self, ann: ANNDef) -> ANNDef:
        """Copy the module's weights into `ann`'s layers (host numpy)."""
        for l, (W, b) in zip(ann.layers, self.params()):
            l.weight = W.detach().cpu().numpy()
            l.bias = b.detach().cpu().numpy()
        return ann


def init_ann(
    name: str, in_dim: int, hidden: List[int], out_dim: int,
    context: int = 4, activation: str = "SIGMOID", seed: int = 0,
) -> ANNDef:
    rng = np.random.default_rng(seed)
    dims = [in_dim * (2 * context + 1)] + hidden + [out_dim]
    layers = []
    for i in range(len(dims) - 1):
        fan_in = dims[i]
        scale = 1.0 / np.sqrt(fan_in)
        W = rng.uniform(-scale, scale, size=(dims[i + 1], dims[i]))
        layers.append(
            Layer(
                weight=W.astype(np.float32),
                bias=np.zeros(dims[i + 1], np.float32),
                activation=activation if i < len(dims) - 2 else "SOFTMAX",
            )
        )
    return ANNDef(name=name, layers=layers, context=context)


# -- text I/O ---------------------------------------------------------------


def save_ann(ann: ANNDef, path: str) -> None:
    with open(path, "w") as f:
        f.write(f'~N "{ann.name}"\n')
        f.write(f"<NUMLAYERS> {len(ann.layers)} <CONTEXT> {ann.context}\n")
        for li, l in enumerate(ann.layers):
            out_d, in_d = l.weight.shape
            f.write(f"<LAYER> {li + 1} <NUMUNITS> {out_d} "
                    f"<ACTIVATION> {l.activation}\n")
            f.write(f"<WEIGHT> {out_d} {in_d}\n")
            for row in l.weight:
                f.write(" " + " ".join("%.6e" % v for v in row) + "\n")
            f.write(f"<BIAS> {out_d}\n")
            f.write(" " + " ".join("%.6e" % v for v in l.bias) + "\n")
        if ann.target_priors is not None:
            f.write(f"<TARGETPRIORS> {len(ann.target_priors)}\n")
            f.write(" " + " ".join("%.6e" % v for v in ann.target_priors) + "\n")
        if ann.target_names:
            f.write(f"<TARGETNAMES> {len(ann.target_names)}\n")
            f.write(" ".join(ann.target_names) + "\n")


def load_ann(path: str) -> ANNDef:
    toks = open(path).read().split()
    i = 0
    ann = ANNDef(name="ann")
    n_layers = 0
    try:
        while i < len(toks):
            t = toks[i]
            if t == "~N":
                ann.name = toks[i + 1].strip('"')
                i += 2
            elif t == "<NUMLAYERS>":
                n_layers = int(toks[i + 1])
                i += 2
            elif t == "<CONTEXT>":
                ann.context = int(toks[i + 1])
                i += 2
            elif t == "<LAYER>":
                i += 2  # index
            elif t == "<NUMUNITS>":
                i += 2
            elif t == "<ACTIVATION>":
                act = toks[i + 1]
                i += 2
            elif t == "<WEIGHT>":
                r, c = int(toks[i + 1]), int(toks[i + 2])
                vals = [float(x) for x in toks[i + 3 : i + 3 + r * c]]
                W = np.array(vals, np.float32).reshape(r, c)
                i += 3 + r * c
            elif t == "<BIAS>":
                n = int(toks[i + 1])
                b = np.array([float(x) for x in toks[i + 2 : i + 2 + n]],
                             np.float32)
                i += 2 + n
                ann.layers.append(Layer(weight=W, bias=b, activation=act))
            elif t == "<TARGETPRIORS>":
                n = int(toks[i + 1])
                ann.target_priors = np.array(
                    [float(x) for x in toks[i + 2 : i + 2 + n]], np.float32
                )
                i += 2 + n
            elif t == "<TARGETNAMES>":
                n = int(toks[i + 1])
                ann.target_names = toks[i + 2 : i + 2 + n]
                i += 2 + n
            else:
                i += 1
    except (IndexError, ValueError) as e:
        HError(7711, "load_ann: malformed ANN file %s (%s)", path, e)
    if len(ann.layers) != n_layers:
        HError(7711, "load_ann: %s declares %d layers, found %d",
               path, n_layers, len(ann.layers))
    return ann
