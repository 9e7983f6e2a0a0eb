"""HTK configuration system.

Mirrors `HTKLib/HShell.c : GetConfig()/GetConfStr/Int/Flt/Bool`:

- Sources: repeatable ``-C file`` options plus the ``HCONFIG`` env var;
  later files override earlier ones, command-line ``-C`` overrides HCONFIG.
- Line syntax: ``[MODULE:] NAME = value`` with ``#`` comments. Names and
  module prefixes are case-insensitive (HTK uppercases both).
- A module-qualified entry (``HPARM: TARGETKIND = MFCC_E_D_A``) beats a
  global one (``TARGETKIND = MFCC``) when a module asks for its parameters.
- Values are typed on read; booleans are T/F/TRUE/FALSE; strings may be
  double-quoted or single-quoted.
- Unknown keys are ignored (tools can dump the resolved table with ``-D``).

Copied from `htk_tpu/utils/config.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .errors import HError

_LINE_RE = re.compile(
    r"^\s*(?:(?P<mod>[A-Za-z][A-Za-z0-9_]*)\s*:)?\s*"
    r"(?P<name>[A-Za-z][A-Za-z0-9_]*)\s*=\s*(?P<val>.*?)\s*$"
)


def _unquote(v: str) -> str:
    if len(v) >= 2 and v[0] == v[-1] and v[0] in ("'", '"'):
        return v[1:-1]
    return v


@dataclass
class Config:
    """Resolved HTK configuration table.

    Entries keyed by (MODULE or None, NAME), both uppercased.
    """

    entries: Dict[Tuple[Optional[str], str], str] = field(default_factory=dict)
    sources: List[str] = field(default_factory=list)

    # -- loading ---------------------------------------------------------

    @classmethod
    def load(cls, files: List[str] | None = None, use_env: bool = True) -> "Config":
        cfg = cls()
        paths: List[str] = []
        if use_env and os.environ.get("HCONFIG"):
            paths.append(os.environ["HCONFIG"])
        if files:
            paths.extend(files)
        for p in paths:
            cfg.read_file(p)
        return cfg

    def read_file(self, path: str) -> None:
        try:
            text = open(path, "r", encoding="utf-8", errors="replace").read()
        except OSError as e:
            HError(1010, "Config: cannot open config file %s (%s)", path, e)
        self.sources.append(path)
        self.read_string(text)

    def read_string(self, text: str) -> None:
        for raw in text.splitlines():
            line = raw.split("#", 1)[0].rstrip()
            if not line.strip():
                continue
            m = _LINE_RE.match(line)
            if not m:
                HError(1050, "Config: bad config line '%s'", raw.strip())
            mod = m.group("mod")
            name = m.group("name").upper()
            val = _unquote(m.group("val"))
            self.entries[(mod.upper() if mod else None, name)] = val

    def set(self, name: str, value: str, module: str | None = None) -> None:
        self.entries[(module.upper() if module else None, name.upper())] = value

    # -- typed access (module-qualified beats global) --------------------

    def _lookup(self, module: Optional[str], name: str) -> Optional[str]:
        name = name.upper()
        if module is not None:
            v = self.entries.get((module.upper(), name))
            if v is not None:
                return v
        return self.entries.get((None, name))

    def has(self, name: str, module: str | None = None) -> bool:
        return self._lookup(module, name) is not None

    def str_(self, name: str, default: str | None = None, module: str | None = None):
        v = self._lookup(module, name)
        return default if v is None else v

    def int_(self, name: str, default: int | None = None, module: str | None = None):
        v = self._lookup(module, name)
        if v is None:
            return default
        try:
            return int(v, 0)
        except ValueError:
            HError(1062, "Config: %s = %s is not an integer", name, v)

    def flt_(self, name: str, default: float | None = None, module: str | None = None):
        v = self._lookup(module, name)
        if v is None:
            return default
        try:
            return float(v)
        except ValueError:
            HError(1062, "Config: %s = %s is not a float", name, v)

    def bool_(self, name: str, default: bool | None = None, module: str | None = None):
        v = self._lookup(module, name)
        if v is None:
            return default
        u = v.strip().upper()
        if u in ("T", "TRUE", "1"):
            return True
        if u in ("F", "FALSE", "0"):
            return False
        HError(1062, "Config: %s = %s is not a boolean (T/F)", name, v)

    # -- dump (-D) -------------------------------------------------------

    def dump(self) -> str:
        lines = ["HTK Configuration Parameters[%d]" % len(self.entries)]
        lines.append("  %-14s  %-24s  %s" % ("Module/Tool", "Parameter", "Value"))
        for (mod, name), val in sorted(
            self.entries.items(), key=lambda kv: (kv[0][0] or "", kv[0][1])
        ):
            lines.append("  %-14s  %-24s  %s" % (mod or "", name, val))
        return "\n".join(lines)
