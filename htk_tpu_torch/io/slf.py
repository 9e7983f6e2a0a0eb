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

Copied from `htk_tpu/io/slf.py` into the PyTorch port: host code, the
same SLF bytes. The port cannot use htk_tpu, whose utils package pulls
in JAX. A lattice may also be held as arrays (`LatticeColumns`, the
decoders' lattice walk emits them): `write_slf` writes those directly,
and its `nodes`/`arcs` lists are built on their first read.
"""

from __future__ import annotations

import contextlib
import gc
from dataclasses import dataclass, field
from itertools import repeat
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.errors import HError, contained
from ..utils.metrics import span

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


@contextlib.contextmanager
def _gc_paused():
    """The cyclic garbage collector paused inside, as it was after. A
    lattice's nodes and arcs are built under it: tens of thousands of
    objects that form no reference cycle, whose allocations would
    otherwise trigger collections that pass over the objects alive
    (about half the build's time on 16,000-record lattices)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


@dataclass(frozen=True, eq=False)
class LatticeColumns:
    """A lattice as arrays. Node k has id k, `time[k]` (float64 seconds)
    and the word `words[word[k]]` (int64 indices; !NULL where negative);
    arc k has id k, runs from node `start[k]` to node `end[k]` (int64)
    and scores `aclike[k]` and `lmlike[k]` (float64). No variants and no
    words on arcs."""

    time: np.ndarray
    word: np.ndarray
    words: Sequence[str]
    start: np.ndarray
    end: np.ndarray
    aclike: np.ndarray
    lmlike: np.ndarray

    def names(self) -> List[str]:
        """Each node's word."""
        words = self.words
        return [NULL_WORD if k < 0 else words[k] for k in self.word.tolist()]

    def lists(self):
        """The `LNode` and `LArc` lists, in the span `htk.lattice.views`."""
        n, m = self.time.size, self.start.size
        with span("htk.lattice.views", nodes=n, arcs=m), _gc_paused():
            nodes = list(map(LNode, range(n), self.time.tolist(),
                             self.names()))
            arcs = list(map(LArc, range(m), self.start.tolist(),
                            self.end.tolist(), repeat(None),
                            self.aclike.tolist(), self.lmlike.tolist()))
        return nodes, arcs


@dataclass
class Lattice:
    """A lattice as `LNode`/`LArc` lists, or (`from_columns`) as arrays
    whose lists are built on the first read of `nodes` or `arcs`; from
    then on the lists are the lattice, and an edit through them is what
    `write_slf` writes."""

    nodes: List[LNode] = field(default_factory=list)
    arcs: List[LArc] = field(default_factory=list)
    utterance: Optional[str] = None
    lmscale: float = 1.0
    wdpenalty: float = 0.0
    header: Dict[str, str] = field(default_factory=dict)

    _columns = None  # a LatticeColumns until the lists are built

    @classmethod
    def from_columns(cls, columns: LatticeColumns, **kw) -> "Lattice":
        """A lattice held as `columns` (`kw`: the other fields)."""
        lat = cls(**kw)
        del lat.nodes, lat.arcs
        lat._columns = columns
        return lat

    def __getattr__(self, name):
        # reached only for an attribute that is not set: `nodes` or
        # `arcs` of a lattice from columns, before their first read
        if name not in ("nodes", "arcs") or self._columns is None:
            raise AttributeError(name)
        for k, v in zip(("nodes", "arcs"), self._columns.lists()):
            vars(self).setdefault(k, v)  # a list set before stays
        self._columns = None
        return vars(self)[name]

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


# %s formats as str() and %.2f as format(x, ".2f"), the bytes of HTK's
# writer, whichever form the lattice is held in
_NODE_LINE = "I=%s t=%.2f%s%s\n"
_ARC_LINE = "J=%s S=%s E=%s%s a=%.2f l=%.4f\n"


def _line_fields(lat: Lattice):
    """The fields of `lat`'s node lines (id, time, word, variant) and arc
    lines (id, start, end, word, aclike, lmlike), each a sequence: from
    its columns while neither list has been read or set, else from its
    lists."""
    cols = getattr(lat, "_columns", None)
    if cols is not None and not {"nodes", "arcs"} & vars(lat).keys():
        none = repeat("")
        return ((range(cols.time.size), cols.time.tolist(),
                 list(map(" W=".__add__, cols.names())), none),
                (range(cols.start.size), cols.start.tolist(),
                 cols.end.tolist(), none, cols.aclike.tolist(),
                 cols.lmlike.tolist()))
    nodes, arcs = lat.nodes, lat.arcs
    return (([n.id for n in nodes], [n.time for n in nodes],
             [f" W={n.word}" if n.word is not None else "" for n in nodes],
             [f" v={n.var}" if n.var else "" for n in nodes]),
            ([a.id for a in arcs], [a.start for a in arcs],
             [a.end for a in arcs],
             [f" W={a.word}" if a.word is not None else "" for a in arcs],
             [a.aclike for a in arcs], [a.lmlike for a in arcs]))


def write_slf(lat: Lattice, path: str) -> None:
    nodes, arcs = _line_fields(lat)
    with open(path, "w") as f:
        f.write("VERSION=1.0\n")
        if lat.utterance:
            f.write(f"UTTERANCE={lat.utterance}\n")
        f.write(f"lmscale={lat.lmscale:.2f} wdpenalty={lat.wdpenalty:.2f}\n")
        f.write(f"N={len(nodes[0])} L={len(arcs[0])}\n")
        f.write("".join(map(_NODE_LINE.__mod__, zip(*nodes))))
        f.write("".join(map(_ARC_LINE.__mod__, zip(*arcs))))
