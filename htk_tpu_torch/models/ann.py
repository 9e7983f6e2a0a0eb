"""ANN definitions (HTK v3.5 HANNet), in torch.

The PyTorch counterpart of `htk_tpu/models/ann.py` (`HTKLib/HANNet.c`):
layered networks (~L layer macros, ~N network macro) with affine +
activation layers and a feature-mix context window (FeaMix: splicing
+/-C frames), used for hybrid decoding (log posterior - log prior
replaces GMM OutP).

The port adds one recurrent layer kind that htk_tpu lacks, `LSTMPLayer`:
the projected LSTM of Sak, Senior and Beaufays (Interspeech 2014), with
peephole connections and a recurrent projection r_t = W_rm m_t that
feeds the gates and the next layer. A net that holds one scores frame t
with its output at frame t + `ANNDef.out_delay` (algo/nnet.hybrid_outp
runs it); training and live decoding refuse it (`require_feedforward`).

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

An LSTMP layer (`<ACTIVATION> LSTMP`, `<NUMUNITS>` its projection n_r)
adds its recurrent, peephole and projection matrices between its
weight and its bias, and a net with an output delay says so in its
header (`<OUTDELAY> 5` after `<CONTEXT>`); a file without either reads
and writes as before:

  <LAYER> 1 <NUMUNITS> 512 <ACTIVATION> LSTMP
  <WEIGHT> 3328 39  ...W_x rows: the gates i, f, c, o, n_c rows each...
  <RECURRENT> 3328 512  ...W_r rows, the same gate order...
  <PEEPHOLE> 3 832  ...p_i, p_f, p_o...
  <PROJECTION> 512 832  ...W_rm rows...
  <BIAS> 3328  ...
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..utils.errors import HError

ACTIVATIONS = ("SIGMOID", "RELU", "TANH", "SOFTMAX", "LINEAR")
LSTMP = "LSTMP"


@dataclass
class Layer:
    weight: np.ndarray  # (out, in)
    bias: np.ndarray  # (out,)
    activation: str = "SIGMOID"


@dataclass
class LSTMPLayer:
    """A projected LSTM layer with peepholes (Sak, Senior and Beaufays
    2014). The rows of `weight`, `recur` and `bias` are the gates i, f,
    c, o in that order, n_c each. Step t, from r_{t-1} and c_{t-1} (both
    0 before the first frame):

      i = sigmoid(W_ix x + W_ir r + p_i * c_{t-1} + b_i)
      f = sigmoid(W_fx x + W_fr r + p_f * c_{t-1} + b_f)
      c_t = f * c_{t-1} + i * tanh(W_cx x + W_cr r + b_c)
      o = sigmoid(W_ox x + W_or r + p_o * c_t + b_o)
      m = o * tanh(c_t);   r_t = W_rm m

    r_t is the layer's output."""

    weight: np.ndarray  # W_x (4 n_c, n_in)
    recur: np.ndarray  # W_r (4 n_c, n_r)
    peep: np.ndarray  # (3, n_c): p_i, p_f, p_o
    bias: np.ndarray  # (4 n_c,)
    proj: np.ndarray  # W_rm (n_r, n_c)
    activation: str = LSTMP


@dataclass
class ANNDef:
    name: str
    layers: List = field(default_factory=list)  # Layer or LSTMPLayer
    context: int = 4  # FeaMix splice window: +/- context frames
    target_priors: Optional[np.ndarray] = None  # (K,) state priors
    target_names: Optional[List[str]] = None  # tied-state macro names
    out_delay: int = 0  # frame t scores with the net's output at t + this

    @property
    def in_dim(self) -> int:
        return self.layers[0].weight.shape[1]

    @property
    def out_dim(self) -> int:
        return ann_out(self.layers[-1])

    @property
    def recurrent(self) -> bool:
        """Whether a layer carries state from frame to frame."""
        return any(l.activation == LSTMP for l in self.layers)


def require_feedforward(ann: ANNDef, what: str) -> None:
    """HError 7713 where `ann` holds a recurrent layer: `what` (training,
    live decoding) runs feed-forward nets only."""
    if ann.recurrent:
        HError(7713, "%s: ANN %s has a recurrent (LSTMP) layer; only "
               "feed-forward nets are supported here", what, ann.name)


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


def ann_out(l) -> int:
    """A layer's output width."""
    return (l.proj if l.activation == LSTMP else l.weight).shape[0]


def ann_arrays(l):
    """A layer's arrays in the order `ann_params` gives them."""
    if l.activation == LSTMP:
        return (l.weight, l.recur, l.peep, l.bias, l.proj)
    return (l.weight, l.bias)


def ann_params(ann: ANNDef, device="cpu"):
    """The ANN's [(W, b), ...] as float32 tensors on `device` (copies:
    updating them leaves `ann` as it is); an LSTMP layer's entry is
    (W_x, W_r, peep, b, W_rm)."""
    return [tuple(torch.tensor(np.asarray(a, np.float32), device=device)
                  for a in ann_arrays(l)) for l in ann.layers]


class ANNModule(nn.Module):
    """An ANNDef as an `nn.Module` on `device`: its parameters are each
    layer's `ann_params` tensors in order (W, b, W, b, ... for a
    feed-forward net); forward(x) gives a feed-forward net's `forward`
    output (pre-softmax logits of a SOFTMAX output layer). A recurrent
    net runs through algo/nnet.hybrid_outp, on `params()`."""

    def __init__(self, ann: ANNDef, device="cpu"):
        super().__init__()
        self.acts = [l.activation for l in ann.layers]
        groups = ann_params(ann, device)
        self.sizes = [len(g) for g in groups]
        self.flat = nn.ParameterList(
            [nn.Parameter(t) for g in groups for t in g])

    def params(self):
        """Each layer's tensors: [(W, b), ...], an LSTMP layer's (W_x,
        W_r, peep, b, W_rm)."""
        flat, out, k = list(self.flat), [], 0
        for n in self.sizes:
            out.append(tuple(flat[k:k + n]))
            k += n
        return out

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
    projection: int = 0, out_delay: int = 0,
) -> ANNDef:
    """Hidden layers of `hidden` units and a SOFTMAX output layer, weights
    uniform in +/-1/sqrt(fan-in), biases 0. With activation LSTMP each
    hidden entry is an LSTMP layer of that many cells and a projection of
    `projection` (its peepholes drawn as its W_x is, over n_c)."""
    rng = np.random.default_rng(seed)

    def draw(rows, cols, fan_in):
        s = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-s, s, size=(rows, cols)).astype(np.float32)

    width = in_dim * (2 * context + 1)
    layers = []
    for n in hidden:
        if activation == LSTMP:
            layers.append(LSTMPLayer(
                weight=draw(4 * n, width, width),
                recur=draw(4 * n, projection, projection),
                peep=draw(3, n, n), bias=np.zeros(4 * n, np.float32),
                proj=draw(projection, n, n)))
            width = projection
            continue
        layers.append(Layer(weight=draw(n, width, width),
                            bias=np.zeros(n, np.float32),
                            activation=activation))
        width = n
    layers.append(Layer(weight=draw(out_dim, width, width),
                        bias=np.zeros(out_dim, np.float32),
                        activation="SOFTMAX"))
    return ANNDef(name=name, layers=layers, context=context,
                  out_delay=out_delay)


# -- text I/O ---------------------------------------------------------------


def _write_matrix(f, tag: str, M: np.ndarray) -> None:
    f.write(f"{tag} {M.shape[0]} {M.shape[1]}\n")
    for row in M:
        f.write(" " + " ".join("%.6e" % v for v in row) + "\n")


def save_ann(ann: ANNDef, path: str) -> None:
    with open(path, "w") as f:
        f.write(f'~N "{ann.name}"\n')
        f.write(f"<NUMLAYERS> {len(ann.layers)} <CONTEXT> {ann.context}"
                + (f" <OUTDELAY> {ann.out_delay}" if ann.out_delay else "")
                + "\n")
        for li, l in enumerate(ann.layers):
            lstmp = l.activation == LSTMP
            f.write(f"<LAYER> {li + 1} <NUMUNITS> {ann_out(l)} "
                    f"<ACTIVATION> {l.activation}\n")
            _write_matrix(f, "<WEIGHT>", l.weight)
            if lstmp:
                _write_matrix(f, "<RECURRENT>", l.recur)
                _write_matrix(f, "<PEEPHOLE>", l.peep)
                _write_matrix(f, "<PROJECTION>", l.proj)
            f.write(f"<BIAS> {len(l.bias)}\n")
            f.write(" " + " ".join("%.6e" % v for v in l.bias) + "\n")
        if ann.target_priors is not None:
            f.write(f"<TARGETPRIORS> {len(ann.target_priors)}\n")
            f.write(" " + " ".join("%.6e" % v for v in ann.target_priors) + "\n")
        if ann.target_names:
            f.write(f"<TARGETNAMES> {len(ann.target_names)}\n")
            f.write(" ".join(ann.target_names) + "\n")


def _lstmp_layer(path, W, b, parts) -> LSTMPLayer:
    """An LSTMP entry's arrays, their shapes checked (HError 7711)."""
    if set(parts) != {"<RECURRENT>", "<PEEPHOLE>", "<PROJECTION>"}:
        HError(7711, "load_ann: %s: an LSTMP layer needs <RECURRENT>, "
               "<PEEPHOLE> and <PROJECTION>, found %s", path,
               " ".join(sorted(parts)) or "none")
    R, P, M = (parts[k] for k in ("<RECURRENT>", "<PEEPHOLE>",
                                  "<PROJECTION>"))
    n_c = P.shape[1]
    if (W.shape[0] != 4 * n_c or R.shape != (4 * n_c, M.shape[0])
            or P.shape[0] != 3 or M.shape[1] != n_c or b.size != 4 * n_c):
        HError(7711, "load_ann: %s: LSTMP shapes do not agree (weight %s, "
               "recurrent %s, peephole %s, projection %s, bias %d)", path,
               W.shape, R.shape, P.shape, M.shape, b.size)
    return LSTMPLayer(weight=W, recur=R, peep=P, bias=b, proj=M)


def load_ann(path: str) -> ANNDef:
    toks = open(path).read().split()
    i = 0
    ann = ANNDef(name="ann")
    n_layers = 0
    parts = {}  # an LSTMP layer's matrices besides its weight
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
            elif t == "<OUTDELAY>":
                ann.out_delay = int(toks[i + 1])
                i += 2
            elif t == "<LAYER>":
                parts = {}
                i += 2  # index
            elif t == "<NUMUNITS>":
                i += 2
            elif t == "<ACTIVATION>":
                act = toks[i + 1]
                i += 2
            elif t in ("<WEIGHT>", "<RECURRENT>", "<PEEPHOLE>",
                       "<PROJECTION>"):
                r, c = int(toks[i + 1]), int(toks[i + 2])
                vals = [float(x) for x in toks[i + 3 : i + 3 + r * c]]
                M = np.array(vals, np.float32).reshape(r, c)
                if t == "<WEIGHT>":
                    W = M
                else:
                    parts[t] = M
                i += 3 + r * c
            elif t == "<BIAS>":
                n = int(toks[i + 1])
                b = np.array([float(x) for x in toks[i + 2 : i + 2 + n]],
                             np.float32)
                i += 2 + n
                ann.layers.append(
                    _lstmp_layer(path, W, b, parts) if act == LSTMP
                    else Layer(weight=W, bias=b, activation=act))
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
