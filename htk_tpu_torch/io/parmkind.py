"""HTK parameter-kind codes (TARGETKIND/SOURCEKIND strings <-> int16 codes).

Mirrors `HTKLib/HParm.c : Str2ParmKind()/ParmKind2Str()`. The int16 code is
what feature-file headers store: a base kind in the low 6 bits plus
qualifier bits (HTK defines these in octal; hex here):

  _E 0x40   has log energy          _Z 0x800   zero-mean statics (CMN)
  _N 0x80   absolute energy suppressed  _K 0x1000  has CRC checksum
  _D 0x100  has delta coefficients  _0 0x2000  has 0'th cepstral coef
  _A 0x200  has acceleration coefs  _V 0x4000  has VQ index
  _C 0x400  is compressed           _T 0x8000  has third derivatives

Copied from `htk_tpu/io/parmkind.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

from ..utils.errors import HError

BASE_KINDS = [
    "WAVEFORM",  # 0
    "LPC",  # 1
    "LPREFC",  # 2
    "LPCEPSTRA",  # 3
    "LPDELCEP",  # 4
    "IREFC",  # 5
    "MFCC",  # 6
    "FBANK",  # 7
    "MELSPEC",  # 8
    "USER",  # 9
    "DISCRETE",  # 10
    "PLP",  # 11
]
ANON = len(BASE_KINDS)  # HTK's ANON pseudo-kind

HASENERGY = 0x40
HASNULLE = 0x80
HASDELTA = 0x100
HASACCS = 0x200
HASCOMPX = 0x400
HASZEROM = 0x800
HASCRCC = 0x1000
HASZEROC = 0x2000
HASVQ = 0x4000
HASTHIRD = 0x8000

BASEMASK = 0x3F

_QUAL_LETTERS = [
    ("E", HASENERGY),
    ("N", HASNULLE),
    ("D", HASDELTA),
    ("A", HASACCS),
    ("C", HASCOMPX),
    ("Z", HASZEROM),
    ("K", HASCRCC),
    ("0", HASZEROC),
    ("V", HASVQ),
    ("T", HASTHIRD),
]

# ParmKind2Str emits qualifiers in this canonical order (HParm.c).
_QUAL_OUT_ORDER = [
    ("E", HASENERGY),
    ("D", HASDELTA),
    ("N", HASNULLE),
    ("A", HASACCS),
    ("T", HASTHIRD),
    ("C", HASCOMPX),
    ("K", HASCRCC),
    ("Z", HASZEROM),
    ("0", HASZEROC),
    ("V", HASVQ),
]


def str2parmkind(s: str) -> int:
    """'MFCC_E_D_A' -> int16 code (HParm.c : Str2ParmKind)."""
    parts = s.strip().upper().split("_")
    base = parts[0]
    if base not in BASE_KINDS:
        HError(6370, "Str2ParmKind: unknown parameter kind %s", s)
    code = BASE_KINDS.index(base)
    for q in parts[1:]:
        for ch in q:  # HTK allows run-together qualifiers e.g. _E_D or _ED
            for letter, bit in _QUAL_LETTERS:
                if ch == letter:
                    code |= bit
                    break
            else:
                HError(6370, "Str2ParmKind: unknown qualifier _%s in %s", ch, s)
    return code


def parmkind2str(code: int) -> str:
    """int16 code -> 'MFCC_E_D_A' (HParm.c : ParmKind2Str)."""
    base = code & BASEMASK
    if base >= len(BASE_KINDS):
        HError(6371, "ParmKind2Str: bad base kind %d", base)
    s = BASE_KINDS[base]
    for letter, bit in _QUAL_OUT_ORDER:
        if code & bit:
            s += "_" + letter
    return s


def base_kind(code: int) -> int:
    return code & BASEMASK


def has_qual(code: int, bit: int) -> bool:
    return bool(code & bit)
