"""Label files and Master Label Files (MLF).

Mirrors `HTKLib/HLabel.c` (LOpen/LSave/LoadMasterFile/SaveToMasterfile):

- Single label files (`.lab`): lines `[start end] name [score] [aux...]`,
  times in 100 ns units.
- MLFs: `#!MLF!#` header, then entries introduced by a quoted pattern line
  (`"*/utt1.lab"`), label lines, terminated by `.`. Patterns may use `*`
  and `?` wildcards; immediate subdirectory search (`-> subdir`) [LC] is
  not supported.
- Multiple alternatives within one transcription separated by `///`.

Source label formats (SOURCELABEL / -G): HTK, TIMIT, ESPS and
SCRIBE/SAM — see `load_label_file`.

Copied from `htk_tpu/io/mlf.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX. `MLF.read` scans through the port's copy of
the native MLF structure scanner (native/htkio.cpp) first, as htk_tpu's
does; the pure parse (`_read_pure`) takes every file the scanner does not
cover and reports the numbered errors.
"""

from __future__ import annotations

import fnmatch
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.errors import HError


@dataclass
class Label:
    name: str
    start: Optional[int] = None  # 100ns units
    end: Optional[int] = None
    score: Optional[float] = None
    aux: List[str] = field(default_factory=list)  # auxiliary labels/scores


@dataclass
class Transcription:
    """One utterance's labels; alternatives = list of label lists."""

    alternatives: List[List[Label]] = field(default_factory=list)

    @property
    def labels(self) -> List[Label]:
        return self.alternatives[0] if self.alternatives else []

    def names(self, alt: int = 0) -> List[str]:
        return [l.name for l in self.alternatives[alt]]


def _parse_label_line(line: str) -> Optional[Label]:
    parts = line.split()
    if not parts:
        return None
    # leading numeric fields are start/end times
    times = []
    i = 0
    while i < len(parts) and i < 2 and re.fullmatch(r"-?\d+", parts[i]):
        times.append(int(parts[i]))
        i += 1
    if i >= len(parts):
        # a line of pure numbers is a (start end) with missing name
        HError(6550, "LOpen: bad label line '%s'", line.strip())
    name = parts[i]
    i += 1
    score = None
    if i < len(parts):
        try:
            score = float(parts[i])
            i += 1
        except ValueError:
            pass
    lab = Label(name=name, score=score, aux=parts[i:])
    if len(times) == 2:
        lab.start, lab.end = times
    elif len(times) == 1:
        lab.start = times[0]
    return lab


def parse_label_body(lines: Sequence[str]) -> Transcription:
    tr = Transcription(alternatives=[[]])
    for raw in lines:
        s = raw.strip()
        if not s:
            continue
        if s == "///":
            tr.alternatives.append([])
            continue
        lab = _parse_label_line(s)
        if lab is not None:
            tr.alternatives[-1].append(lab)
    return tr


def format_label_body(tr: Transcription, with_times: bool = True,
                      with_scores: bool = False) -> str:
    out = []
    for ai, alt in enumerate(tr.alternatives):
        if ai > 0:
            out.append("///")
        for l in alt:
            fields = []
            if with_times and l.start is not None and l.end is not None:
                fields += [str(l.start), str(l.end)]
            fields.append(l.name)
            if with_scores and l.score is not None:
                fields.append("%.6f" % l.score)
            fields += l.aux
            out.append(" ".join(fields))
    return "\n".join(out) + "\n"


class MLF:
    """An in-memory Master Label File (pattern -> transcription).

    Loading is lazy-matched like HTK: a lookup for logical name `foo` tries
    each pattern in file order against `*/foo.lab` style keys
    (HLabel.c MLF search semantics).
    """

    def __init__(self):
        self.entries: List[Tuple[str, Transcription]] = []
        self._exact: Dict[str, Transcription] = {}

    @classmethod
    def load(cls, path: str, cfg=None) -> "MLF":
        m = cls()
        m.read(path, cfg)
        return m

    def read(self, path: str, cfg=None) -> None:
        from ..utils.filters import filtered

        try:
            with filtered(path, "HLABELFILTER", cfg) as p:
                data = open(p, "rb").read()
        except OSError as e:
            HError(6510, "LoadMasterFile: cannot open MLF %s (%s)", path, e)
        if self._read_native(data):
            return
        self._read_pure(data, path)

    def _read_pure(self, data: bytes, path: str) -> None:
        lines = data.decode(errors="replace").splitlines()
        if not lines or lines[0].strip() != "#!MLF!#":
            HError(6511, "LoadMasterFile: %s missing #!MLF!# header", path)
        i = 1
        n = len(lines)
        while i < n:
            s = lines[i].strip()
            i += 1
            if not s:
                continue
            if not (s.startswith('"') and s.endswith('"')):
                HError(6512, "LoadMasterFile: expected pattern line, got '%s'", s)
            pattern = s[1:-1]
            body = []
            while i < n:
                t = lines[i].strip()
                i += 1
                if t == ".":
                    break
                body.append(t)
            tr = parse_label_body(body)
            self.entries.append((pattern, tr))
            self._exact[pattern] = tr

    def _read_native(self, data: bytes) -> bool:
        """Fast path: the C scanner (native/htkio.cpp htkio_mlf_marks)
        finds every pattern/terminator line in one pass; Python only
        slices entry bodies. Returns False (caller takes the pure path,
        which also produces the numbered errors) when the file's
        structure is not strictly pattern/body/'.' alternating."""
        from ..native import get_htkio

        lib = get_htkio()
        if not data.startswith(b"#!MLF!#"):
            return False
        import ctypes

        import numpy as np

        cap = data.count(b"\n") + 2
        offs = np.empty(cap, np.int64)
        ends = np.empty(cap, np.int64)
        tags = np.empty(cap, np.uint8)
        cnt = lib.htkio_mlf_marks(
            data, len(data),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            tags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            cap)
        if cnt < 0:
            return False
        # strict alternation pattern/dot; anything else -> pure path
        if cnt % 2 or not all(
                int(tags[k]) == (1 if k % 2 == 0 else 2)
                for k in range(cnt)):
            return False
        for k in range(0, cnt, 2):
            a, b = int(offs[k]), int(ends[k])
            s = data[a:b].decode(errors="replace")
            if not (s.startswith('"') and s.endswith('"')):
                return False
            pattern = s[1:-1]
            body = data[b:int(offs[k + 1])].decode(errors="replace")
            tr = parse_label_body(body.split("\n"))
            self.entries.append((pattern, tr))
            self._exact[pattern] = tr
        return True

    def lookup(self, key: str) -> Optional[Transcription]:
        """Find the transcription for a label-file path/name.

        `key` is the label filename a tool would open, e.g. `dir/utt1.lab`.
        Matches exact pattern first, then fnmatch wildcards in file order.
        """
        if key in self._exact:
            return self._exact[key]
        base = os.path.basename(key)
        for pattern, tr in self.entries:
            if fnmatch.fnmatchcase(key, pattern):
                return tr
            # HTK's '*' in patterns matches across '/' for the common
            # "*/name.lab" idiom; emulate by also matching the basename.
            if pattern.startswith("*/") and fnmatch.fnmatchcase(base, pattern[2:]):
                return tr
        return None

    def add(self, pattern: str, tr: Transcription) -> None:
        self.entries.append((pattern, tr))
        self._exact[pattern] = tr

    def save(self, path: str, with_times: bool = True,
             with_scores: bool = False, cfg=None):
        from ..utils.filters import filtered_output

        with filtered_output(path, "HLABELOFILTER", cfg) as p, \
                open(p, "w") as f:
            f.write("#!MLF!#\n")
            for pattern, tr in self.entries:
                f.write(f'"{pattern}"\n')
                f.write(format_label_body(tr, with_times, with_scores))
                f.write(".\n")


def load_label_file(path: str, fmt: str = "HTK", cfg=None) -> Transcription:
    """Read a single .lab file (HLabel.c : LOpen).

    `fmt` selects the source label format (SOURCELABEL / tool -G):
      HTK    "[start end] name [score]" with times in 100 ns units
      TIMIT  "start end name" with times in SAMPLE counts at 16 kHz
             (HLabel's fixed TIMIT convention: x 625 -> 100 ns)
      ESPS   header lines up to a '#' line, then "time color name" with
             the END time in seconds (each label runs from the previous
             time) [LC - field layout from the published waves+ manual]
      SCRIBE a subset of the European SAM label format: text lines
             "KEY: fields"; HTK recognises the three label keys
             LBA (acoustic label), LBB (broad-class label) and
             UTS (utterance), each carrying
             "start, centre, end, name" with start/end in SAMPLE
             counts (centre ignored); every other SAM key line is
             skipped. Sample counts scale to 100 ns by SOURCERATE
             (HWAVE config, default 625 = 16 kHz). [LC - field layout
             from the published SAM/EUROM documentation and the
             HTKBook's SCRIBE section; reference mount empty]
    """
    try:
        lines = open(path, "r").read().splitlines()
    except OSError as e:
        HError(6510, "LOpen: cannot open label file %s (%s)", path, e)
    fmt = (fmt or "HTK").upper()
    if fmt == "HTK":
        return parse_label_body(lines)
    tr = Transcription(alternatives=[[]])
    if fmt == "TIMIT":
        for raw in lines:
            t = raw.split()
            if len(t) >= 3:
                tr.alternatives[0].append(Label(
                    name=t[2], start=int(t[0]) * 625, end=int(t[1]) * 625))
        return tr
    if fmt == "ESPS":
        body = False
        prev = 0
        for raw in lines:
            st = raw.strip()
            if not body:
                body = st == "#"
                continue
            t = st.split()
            if len(t) >= 3:
                end = int(float(t[0]) * 1.0e7)
                tr.alternatives[0].append(Label(
                    name=t[2], start=prev, end=end))
                prev = end
        return tr
    if fmt == "SCRIBE":
        rate = 625.0
        if cfg is not None:
            rate = cfg.flt_("SOURCERATE", rate, module="HWAVE")
        for raw in lines:
            st = raw.strip()
            key, sep, rest = st.partition(":")
            if not sep or key.strip().upper() not in ("LBA", "LBB", "UTS"):
                continue
            t = [x.strip() for x in rest.split(",")]
            if len(t) < 4 or not t[0] or not t[2]:
                continue
            tr.alternatives[0].append(Label(
                name=t[3],
                start=int(round(float(t[0]) * rate)),
                end=int(round(float(t[2]) * rate))))
        return tr
    HError(6550, "load_label_file: unsupported label format %s", fmt)


def save_label_file(path: str, tr: Transcription, with_times: bool = True):
    with open(path, "w") as f:
        f.write(format_label_body(tr, with_times))


def find_labels(
    logical: str,
    mlfs: Sequence[MLF],
    label_dir: Optional[str] = None,
    label_ext: str = "lab",
    fmt: str = "HTK",
) -> Transcription:
    """Resolve an utterance's transcription the way HTK tools do.

    Tools derive the label filename from the data file's logical name
    (-L dir overrides directory, -X ext overrides extension), then search
    loaded MLFs (-I) in order, falling back to the actual file on disk.
    """
    stem = os.path.splitext(os.path.basename(logical))[0]
    name = f"{stem}.{label_ext}"
    key = os.path.join(label_dir, name) if label_dir else name
    for m in mlfs:
        tr = m.lookup(key)
        if tr is not None:
            return tr
    if os.path.exists(key):
        return load_label_file(key, fmt)
    # try alongside the data file
    alt = os.path.join(os.path.dirname(logical), name)
    for m in mlfs:
        tr = m.lookup(alt)
        if tr is not None:
            return tr
    if os.path.exists(alt):
        return load_label_file(alt)
    HError(6513, "find_labels: no transcription found for %s", logical)
