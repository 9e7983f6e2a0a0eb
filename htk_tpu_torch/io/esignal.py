"""ESIG (Entropic Esignal) file format — read/write.

Mirrors the role of `HTKLib/esignal.c` (+ esig_asc/esig_edr/esig_nat):
the legacy Entropic feature/waveform container that HWave and HParm
accept via SOURCEFORMAT = ESIG.

Layout implemented (Esignal spec shape):

  preamble — six ASCII lines, each newline-terminated:
      "Esignal", version ("0.0B"), architecture ("ASCII" | "EDR1" |
      "NATIVE"), preamble size, total header size, record size (bytes;
      data records follow the header immediately).
  header — a field list. This implementation carries the subset HTK
      itself consumes: global fields `commandLine` (CHAR), `recordFreq`
      (DOUBLE, records/sec) and `startTime` (DOUBLE), plus the per-
      record field `samples` (SHORT for waveforms, FLOAT for feature
      streams) with its element count; terminated by `endHeader`.
      ASCII architecture writes one `name type count` line then the
      values; EDR1 writes the same structure with big-endian binary
      values; NATIVE reads as little-endian (this machine's order).
  data — nRecords * recordSize bytes (EDR1/NATIVE) or whitespace-
      separated numbers (ASCII).

[LC] The full Esignal field-spec grammar (ranks, units, axes, nested
subfields) is richer than this subset; the exact esignal.c grammar was
not at hand when this was written, so reading is lenient (unknown header
lines are skipped until `endHeader`) and writing sticks to the subset
above. Byte parity is untested against real Entropic files.

Copied from `htk_tpu/io/esignal.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from ..utils.errors import HError

MAGIC = b"Esignal"
VERSION = "0.0B"

_TYPE_NP = {
    "SHORT": (">i2", "<i2", 2),
    "LONG": (">i4", "<i4", 4),
    "FLOAT": (">f4", "<f4", 4),
    "DOUBLE": (">f8", "<f8", 8),
}


@dataclass
class EsigFile:
    data: np.ndarray  # (nRecords, width)
    record_freq: float = 0.0  # records per second
    start_time: float = 0.0
    dtype_name: str = "FLOAT"
    arch: str = "EDR1"
    globals_: Dict[str, object] = field(default_factory=dict)

    @property
    def samp_period(self) -> int:
        """100 ns units (HTK convention); 0 when recordFreq is unset."""
        return int(round(1e7 / self.record_freq)) if self.record_freq else 0


def read_esig(path: str) -> EsigFile:
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        HError(6210, "ReadEsig: cannot open %s (%s)", path, e)
    if not raw.startswith(MAGIC):
        HError(6251, "ReadEsig: %s has no Esignal magic", path)

    # six-line ASCII preamble
    pos = 0
    lines = []
    for _ in range(6):
        nl = raw.find(b"\n", pos)
        if nl < 0:
            HError(6251, "ReadEsig: %s truncated preamble", path)
        lines.append(raw[pos:nl].decode("latin-1").strip())
        pos = nl + 1
    arch = lines[2].upper()
    try:
        hdr_size = int(lines[4])
        rec_size = int(lines[5])
    except ValueError:
        HError(6251, "ReadEsig: %s bad preamble sizes", path)

    ef = EsigFile(data=np.zeros((0, 0), np.float32), arch=arch)
    big = arch != "NATIVE"
    n_elems = None

    # header field list: parse until endHeader (lenient)
    hpos = pos
    while hpos < len(raw):
        nl = raw.find(b"\n", hpos)
        if nl < 0:
            break
        line = raw[hpos:nl].decode("latin-1").strip()
        hpos = nl + 1
        if line == "endHeader":
            break
        parts = line.split()
        if len(parts) < 3:
            continue
        name, typ = parts[0], parts[1].upper()
        try:
            count = int(parts[2])
        except ValueError:
            continue
        if name == "samples":
            ef.dtype_name = typ
            n_elems = count
            continue
        if typ == "CHAR":
            val = raw[hpos : hpos + count].decode("latin-1")
            hpos += count
            if hpos < len(raw) and raw[hpos : hpos + 1] == b"\n":
                hpos += 1
            ef.globals_[name] = val
            continue
        if typ in _TYPE_NP:
            bedt, ledt, width = _TYPE_NP[typ]
            if arch == "ASCII":
                nl = raw.find(b"\n", hpos)
                vals = [float(x) for x in raw[hpos:nl].split()]
                hpos = nl + 1
            else:
                dt = bedt if big else ledt
                vals = np.frombuffer(raw, dtype=dt, count=count,
                                     offset=hpos).tolist()
                hpos += width * count
                if raw[hpos : hpos + 1] == b"\n":
                    hpos += 1
            ef.globals_[name] = vals[0] if count == 1 else vals
    ef.record_freq = float(ef.globals_.get("recordFreq", 0.0) or 0.0)
    ef.start_time = float(ef.globals_.get("startTime", 0.0) or 0.0)

    # data records start at headerSize when given, else right here
    dpos = hdr_size if hdr_size > 0 else hpos
    if ef.dtype_name not in _TYPE_NP:
        HError(6251, "ReadEsig: %s unsupported samples type %s",
               path, ef.dtype_name)
    bedt, ledt, width = _TYPE_NP[ef.dtype_name]
    if arch == "ASCII":
        vals = np.array([float(x) for x in raw[dpos:].split()])
        if n_elems:
            vals = vals[: (len(vals) // n_elems) * n_elems]
            ef.data = vals.reshape(-1, n_elems)
        else:
            ef.data = vals.reshape(-1, 1)
    else:
        if n_elems is None:
            if not rec_size:
                HError(6251, "ReadEsig: %s has no samples field and no "
                             "record size", path)
            n_elems = rec_size // width
        dt = bedt if big else ledt
        count = ((len(raw) - dpos) // (width * n_elems)) * n_elems
        vals = np.frombuffer(raw, dtype=dt, count=count, offset=dpos)
        ef.data = vals.reshape(-1, n_elems)
    if ef.dtype_name == "SHORT":
        ef.data = ef.data.astype(np.int16)
    elif ef.dtype_name == "LONG":
        ef.data = ef.data.astype(np.int32)
    else:
        ef.data = ef.data.astype(np.float32)
    return ef


def write_esig(path: str, data: np.ndarray, record_freq: float,
               start_time: float = 0.0, arch: str = "EDR1",
               dtype_name: Optional[str] = None) -> None:
    data = np.asarray(data)
    if data.ndim == 1:
        data = data.reshape(-1, 1)
    if dtype_name is None:
        dtype_name = "SHORT" if data.dtype.kind == "i" else "FLOAT"
    arch = arch.upper()
    bedt, ledt, width = _TYPE_NP[dtype_name]
    n_elems = data.shape[1]

    dbl = ">f8" if arch != "NATIVE" else "<f8"
    hdr = bytearray()
    if arch == "ASCII":
        hdr += ("recordFreq DOUBLE 1\n%.17g\n" % float(record_freq)).encode()
        hdr += ("startTime DOUBLE 1\n%.17g\n" % float(start_time)).encode()
    else:
        hdr += b"recordFreq DOUBLE 1\n"
        hdr += np.asarray([record_freq], dbl).tobytes() + b"\n"
        hdr += b"startTime DOUBLE 1\n"
        hdr += np.asarray([start_time], dbl).tobytes() + b"\n"
    hdr += ("samples %s %d\n" % (dtype_name, n_elems)).encode()
    hdr += b"endHeader\n"

    rec_size = width * n_elems
    # fixed-width size fields keep the preamble length self-consistent
    pre = MAGIC + b"\n" + VERSION.encode() + b"\n" + arch.encode() + b"\n"
    pre_size = len(pre) + 27  # three 8-char fields + newlines
    total_hdr = pre_size + len(hdr)
    pre += ("%8d\n%8d\n%8d\n" % (pre_size, total_hdr, rec_size)).encode()

    if arch == "ASCII":
        body = "\n".join(
            " ".join(repr(float(x)) if dtype_name in ("FLOAT", "DOUBLE")
                     else str(int(x)) for x in row)
            for row in data).encode() + b"\n"
    else:
        dt = bedt if arch != "NATIVE" else ledt
        body = np.ascontiguousarray(data).astype(dt).tobytes()
    with open(path, "wb") as f:
        f.write(pre + bytes(hdr) + body)
