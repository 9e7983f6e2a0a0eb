"""HTK item lists — the pattern language of HHEd/HERest -u.

Mirrors `HTKLib/HUtil.c : PItemList()`: an item list selects sets of model
substructures, e.g.

  {*.transP}                      all transition matrices
  {(aa,ae,ax).state[2-4]}         states 2-4 of the named models
  {(*-aa+*,aa+*,*-aa,aa).state[2]}   the aa triphone family's state 2
  {*.state[2-4].mix}              all mixtures of those states
  {*.state[2].mix[1].mean}        a specific mean

Returns typed item tuples the HHEd commands operate on. Name patterns use
HTK wildcards (* and ?) matched against model names.

Copied from `htk_tpu/models/itemlist.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot import htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

import fnmatch
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..io.mmf import HMMDef, HMMSet, StateInfo, StreamElem
from ..utils.errors import HError


@dataclass
class Item:
    """One selected structure with its owner chain."""

    hmm: HMMDef
    kind: str  # 'hmm' | 'transP' | 'state' | 'stream' | 'mix' | 'mean' | 'cov' | 'weights' | 'dur'
    state_idx: Optional[int] = None  # HTK numbering (2..N-1)
    stream_idx: int = 1
    mix_idx: Optional[int] = None  # 1-based


_LIST_RE = re.compile(
    r"^\{(?P<names>[^.}]+)"
    r"(?:\.(?P<rest>.*))?\}$"
)
_IDX_RE = re.compile(r"^(?P<what>\w+)(?:\[(?P<lo>\d+)(?:-(?P<hi>\d+))?\])?$")


def _parse_names(tok: str) -> List[str]:
    tok = tok.strip()
    if tok.startswith("(") and tok.endswith(")"):
        return [t.strip().strip('"') for t in tok[1:-1].split(",")]
    return [tok.strip('"')]


def _split_top_commas(body: str) -> List[str]:
    """Split an item-list body on commas outside parentheses."""
    parts = []
    depth = 0
    cur = []
    for ch in body:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def parse_item_list(spec: str, hset: HMMSet) -> List[Item]:
    spec = spec.strip()
    if spec.startswith("{") and spec.endswith("}"):
        # multiple comma-separated items at top level, e.g.
        # {sil.state[3],sp.state[2]} (the tutorial sil-tying idiom)
        parts = _split_top_commas(spec[1:-1])
        if len(parts) > 1:
            items: List[Item] = []
            for p in parts:
                items.extend(parse_item_list("{" + p.strip() + "}", hset))
            return items
    m = _LIST_RE.match(spec)
    if not m:
        HError(7230, "PItemList: bad item list %s", spec)
    patterns = _parse_names(m.group("names"))
    rest = m.group("rest") or ""
    parts = [p for p in rest.split(".") if p]

    hmms = []
    for name, h in hset.hmms.items():
        if any(fnmatch.fnmatchcase(name, p) for p in patterns):
            hmms.append(h)
    if not hmms:
        HError(7231, "PItemList: no HMMs match %s", spec)

    if not parts:
        return [Item(hmm=h, kind="hmm") for h in hmms]

    p0 = _IDX_RE.match(parts[0])
    if not p0:
        HError(7230, "PItemList: bad component %s in %s", parts[0], spec)
    what = p0.group("what").lower()

    if what == "transp":
        return [Item(hmm=h, kind="transP") for h in hmms]

    if what != "state":
        HError(7230, "PItemList: expected state/transP, got %s", what)
    lo = int(p0.group("lo")) if p0.group("lo") else 2
    hi = int(p0.group("hi")) if p0.group("hi") else (
        int(p0.group("lo")) if p0.group("lo") else 10 ** 6
    )

    items: List[Item] = []
    for h in hmms:
        for s in range(max(2, lo), min(h.nstates - 1, hi) + 1):
            items.append(Item(hmm=h, kind="state", state_idx=s))

    for part in parts[1:]:
        pm = _IDX_RE.match(part)
        if not pm:
            HError(7230, "PItemList: bad component %s in %s", part, spec)
        w = pm.group("what").lower()
        if w == "stream":
            si = int(pm.group("lo") or 1)
            for it in items:
                it.stream_idx = si
        elif w == "mix":
            mlo = int(pm.group("lo")) if pm.group("lo") else None
            mhi = int(pm.group("hi")) if pm.group("hi") else mlo
            new = []
            for it in items:
                st = it.hmm.states[it.state_idx - 2]
                se = st.streams[it.stream_idx - 1]
                if mlo is None:
                    rng = range(1, len(se.mixes) + 1)
                else:
                    rng = range(mlo, min(mhi, len(se.mixes)) + 1)
                for mi in rng:
                    new.append(Item(hmm=it.hmm, kind="mix",
                                    state_idx=it.state_idx,
                                    stream_idx=it.stream_idx, mix_idx=mi))
            items = new
        elif w in ("mean", "cov", "weights", "dur"):
            for it in items:
                it.kind = w
        else:
            HError(7230, "PItemList: unknown component %s", w)
    return items


def get_state(hset: HMMSet, it: Item) -> StateInfo:
    return it.hmm.states[it.state_idx - 2]
