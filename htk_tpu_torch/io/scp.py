"""HTK extended filenames (script-file entries).

Mirrors `HTKLib/HShell.c` extended-filename handling used by HParm/HWave:

  physical              plain path
  logical=physical      alias: tools report/label by `logical`, read `physical`
  path[start,end]       segment selection: use samples/frames start..end
                        (inclusive, 0-based — HTK semantics)
  logical=path[s,e]     both combined

Copied from `htk_tpu/io/scp.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

_SEG_RE = re.compile(r"^(?P<path>.*)\[(?P<s>\d+),(?P<e>\d+)\]$")


@dataclass(frozen=True)
class ScpEntry:
    logical: str
    physical: str
    start: Optional[int] = None  # inclusive
    end: Optional[int] = None  # inclusive


def parse_scp_entry(entry: str) -> ScpEntry:
    logical = entry
    physical = entry
    if "=" in entry:
        logical, physical = entry.split("=", 1)
    m = _SEG_RE.match(physical)
    start = end = None
    if m:
        physical = m.group("path")
        start = int(m.group("s"))
        end = int(m.group("e"))
    if "=" not in entry:
        logical = physical
    return ScpEntry(logical=logical, physical=physical, start=start, end=end)
