"""SLF (Standard Lattice Format) read/write.

Mirrors `HTKLib/HLat.c : ReadLattice()/WriteLattice()`:

  VERSION=1.0
  UTTERANCE=...    lmscale=...  wdpenalty=...
  N=<nodes> L=<links>
  I=0 t=0.00 W=!NULL
  ...
  J=0 S=0 E=1 W=word a=<acoustic> l=<lm prob>

Words may sit on nodes (W= on I lines) or on arcs (W= on J lines); both
forms round-trip. Times are seconds; scores are natural-log.

Copied from `htk_tpu/io/slf.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..utils.errors import HError, contained

NULL_WORD = "!NULL"


@dataclass(slots=True)
class LNode:
    id: int
    time: float = 0.0
    word: Optional[str] = None  # node-based word (or None)
    var: int = 0  # pronunciation variant


@dataclass(slots=True)
class LArc:
    id: int
    start: int
    end: int
    word: Optional[str] = None  # arc-based word (or None)
    aclike: float = 0.0  # acoustic log-likelihood
    lmlike: float = 0.0  # LM log prob
    var: int = 0


@dataclass
class Lattice:
    nodes: List[LNode] = field(default_factory=list)
    arcs: List[LArc] = field(default_factory=list)
    utterance: Optional[str] = None
    lmscale: float = 1.0
    wdpenalty: float = 0.0
    header: Dict[str, str] = field(default_factory=dict)

    @property
    def word_on_nodes(self) -> bool:
        return any(n.word is not None for n in self.nodes)

    def start_node(self) -> int:
        has_in = {a.end for a in self.arcs}
        for n in self.nodes:
            if n.id not in has_in:
                return n.id
        HError(8250, "Lattice: no start node (cyclic?)")

    def end_node(self) -> int:
        has_out = {a.start for a in self.arcs}
        for n in self.nodes:
            if n.id not in has_out:
                return n.id
        HError(8251, "Lattice: no end node (cyclic?)")


def _parse_fields(line: str) -> Dict[str, str]:
    out = {}
    for tok in line.split():
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k] = v
    return out


def read_slf(path: str, cfg=None) -> Lattice:
    from ..utils.filters import filtered

    try:
        with filtered(path, "HNETFILTER", cfg) as p:
            lines = open(p, "r", errors="replace").read().splitlines()
    except OSError as e:
        HError(8210, "ReadLattice: cannot open %s (%s)", path, e)
    lat = Lattice()
    n_nodes = n_arcs = None
    with contained(8253, "ReadLattice", path):
        return _parse_slf(lines, lat, n_nodes, n_arcs, path)


def _parse_slf(lines, lat, n_nodes, n_arcs, path) -> Lattice:
    for raw in lines:
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        f = _parse_fields(line)
        if "I" in f:
            nid = int(f["I"])
            lat.nodes.append(
                LNode(
                    id=nid,
                    time=float(f.get("t", 0.0)),
                    word=f.get("W"),
                    var=int(f.get("v", 0)),
                )
            )
        elif "J" in f:
            lat.arcs.append(
                LArc(
                    id=int(f["J"]),
                    start=int(f["S"]),
                    end=int(f["E"]),
                    word=f.get("W"),
                    aclike=float(f.get("a", 0.0)),
                    lmlike=float(f.get("l", 0.0)),
                    var=int(f.get("v", 0)),
                )
            )
        else:
            if "N" in f:
                n_nodes = int(f["N"])
            if "L" in f:
                n_arcs = int(f["L"])
            for k, v in f.items():
                if k not in ("N", "L"):
                    lat.header[k] = v
    if "lmscale" in lat.header:
        lat.lmscale = float(lat.header["lmscale"])
    if "wdpenalty" in lat.header:
        lat.wdpenalty = float(lat.header["wdpenalty"])
    lat.utterance = lat.header.get("UTTERANCE")
    if n_nodes is not None and len(lat.nodes) != n_nodes:
        HError(8252, "ReadLattice: %s declares N=%d but has %d nodes",
               path, n_nodes, len(lat.nodes))
    if n_arcs is not None and len(lat.arcs) != n_arcs:
        HError(8252, "ReadLattice: %s declares L=%d but has %d links",
               path, n_arcs, len(lat.arcs))
    lat.nodes.sort(key=lambda n: n.id)
    return lat


def write_slf(lat: Lattice, path: str) -> None:
    with open(path, "w") as f:
        f.write("VERSION=1.0\n")
        if lat.utterance:
            f.write(f"UTTERANCE={lat.utterance}\n")
        f.write(f"lmscale={lat.lmscale:.2f} wdpenalty={lat.wdpenalty:.2f}\n")
        f.write(f"N={len(lat.nodes)} L={len(lat.arcs)}\n")
        for n in lat.nodes:
            w = f" W={n.word}" if n.word is not None else ""
            v = f" v={n.var}" if n.var else ""
            f.write(f"I={n.id} t={n.time:.2f}{w}{v}\n")
        for a in lat.arcs:
            w = f" W={a.word}" if a.word is not None else ""
            f.write(
                f"J={a.id} S={a.start} E={a.end}{w} "
                f"a={a.aclike:.2f} l={a.lmlike:.4f}\n"
            )
