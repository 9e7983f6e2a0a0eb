"""VQ codebooks (HVQ role).

Mirrors `HTKLib/HVQ.c`: codebook create/load/save and nearest-neighbour
quantisation for DISCRETE/_V front-ends. Linear codebooks only (HTK's
binary-tree codebooks are an optimisation for scalar CPUs; on TPU the
full distance matrix is one matmul, so the tree is pointless). File
format follows HVQ's text table: a header line

  magic type cov_kind num_nodes num_streams w1 [w2 ...]

then one line per node: stream vq_id node_id left_id right_id followed by
the mean vector. [LC] byte-parity with HTK .vq files unverified.

Copied from `htk_tpu/io/vq.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..utils.errors import HError, contained

MAGIC = 1984


@dataclass
class VQTable:
    codebooks: List[np.ndarray]  # per stream: (K, D)
    type_: int = 0  # 0 = linear
    cov_kind: str = "NULLC"

    def quantize(self, x: np.ndarray, stream: int = 0) -> np.ndarray:
        """(T, D) -> (T,) nearest codeword indices (1-based like HTK)."""
        cb = self.codebooks[stream]
        d2 = ((x[:, None, :] - cb[None, :, :]) ** 2).sum(-1)
        return d2.argmin(axis=1).astype(np.int32) + 1


def save_vq(vq: VQTable, path: str) -> None:
    with open(path, "w") as f:
        widths = [cb.shape[1] for cb in vq.codebooks]
        total = sum(cb.shape[0] for cb in vq.codebooks)
        f.write(
            f"{MAGIC} {vq.type_} 0 {total} {len(vq.codebooks)} "
            + " ".join(str(w) for w in widths) + "\n"
        )
        for s, cb in enumerate(vq.codebooks):
            for i, row in enumerate(cb):
                f.write(
                    f"{s + 1} {i + 1} {i + 1} 0 0 "
                    + " ".join("%.6e" % v for v in row) + "\n"
                )


def load_vq(path: str) -> VQTable:
    try:
        lines = [l for l in open(path, errors="replace").read().splitlines()
                 if l.strip()]
    except OSError as e:
        HError(5810, "LoadVQTab: cannot open %s (%s)", path, e)
    with contained(5850, "LoadVQTab", path):
        return _parse_vq(lines, path)


def _parse_vq(lines, path: str) -> VQTable:
    hdr = lines[0].split()
    if int(hdr[0]) != MAGIC:
        HError(5850, "LoadVQTab: bad magic in %s", path)
    type_ = int(hdr[1])
    n_nodes = int(hdr[3])
    n_streams = int(hdr[4])
    widths = [int(x) for x in hdr[5 : 5 + n_streams]]
    per_stream: List[List[np.ndarray]] = [[] for _ in range(n_streams)]
    for ln in lines[1 : 1 + n_nodes]:
        parts = ln.split()
        s = int(parts[0]) - 1
        vec = np.array([float(x) for x in parts[5 : 5 + widths[s]]], np.float32)
        per_stream[s].append(vec)
    return VQTable(codebooks=[np.stack(v) for v in per_stream], type_=type_)
