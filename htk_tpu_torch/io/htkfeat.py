"""HTK feature (parameter) file reader/writer.

Mirrors the file format handled by `HTKLib/HParm.c` (OpenParmFile/WriteParm):

  12-byte header (big-endian by default):
    int32  nSamples     number of samples (frames) in file
    int32  sampPeriod   sample period in 100 ns units
    int16  sampSize     bytes per sample
    int16  parmKind     base kind + qualifier bits (see parmkind.py)

  data: nSamples rows of float32 (or int16 for WAVEFORM/IREFC/DISCRETE and
  compressed files), big-endian unless NATURALREADORDER/NATURALWRITEORDER.

Compression (_C qualifier, HParm.c): each column j is scaled to int16 by
  c = A_j * x - B_j     with  A_j = 2*32767/(max_j-min_j),
                              B_j = 32767*(max_j+min_j)/(max_j-min_j)
The A and B float32 vectors are stored before the data and the header's
nSamples is incremented by 4 (each float32 vector occupies the space of two
int16 rows).

Checksum (_K qualifier): a 16-bit CCITT CRC over the data section stored as
a trailing uint16. [LC] Canonical HTK's exact CRC polynomial could not be
byte-verified against the (absent) reference; reads of foreign files treat a
mismatch as a warning, and our own write/read round-trips are exact.

Copied from `htk_tpu/io/htkfeat.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.errors import HError, HRError, contained
from . import parmkind as pk


@dataclass
class HTKFeatureFile:
    data: np.ndarray  # (nSamples, width) float32 (or int16 for waveform kinds)
    samp_period: int  # 100ns units
    parm_kind: int

    @property
    def kind_str(self) -> str:
        return pk.parmkind2str(self.parm_kind)


def _crc16(data: bytes, crc: int = 0xFFFF) -> int:
    """CCITT CRC-16 (poly 0x1021), processed per byte, init 0xffff."""
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) if (crc & 0x8000) else (crc << 1)
        crc &= 0xFFFF
    return crc


def write_htk_file(
    path: str,
    data: np.ndarray,
    samp_period: int,
    parm_kind: int,
    natural_order: bool = False,
) -> None:
    """Write an HTK feature file (HParm.c : WriteParm equivalent)."""
    data = np.asarray(data)
    if data.ndim != 2:
        HError(6372, "write_htk_file: data must be 2-D, got shape %s", data.shape)
    n, width = data.shape
    bo = "<" if natural_order else ">"
    base = pk.base_kind(parm_kind)
    int_kind = base in (
        pk.BASE_KINDS.index("WAVEFORM"),
        pk.BASE_KINDS.index("IREFC"),
        pk.BASE_KINDS.index("DISCRETE"),
    )
    compressed = pk.has_qual(parm_kind, pk.HASCOMPX) and not int_kind
    with_crc = pk.has_qual(parm_kind, pk.HASCRCC)

    if compressed:
        x = data.astype(np.float64)
        xmax = x.max(axis=0)
        xmin = x.min(axis=0)
        rng = np.maximum(xmax - xmin, 1e-10)
        A = 2.0 * 32767.0 / rng
        B = 32767.0 * (xmax + xmin) / rng
        q = np.clip(np.round(A * x - B), -32767, 32767).astype(np.int16)
        payload = (
            A.astype(f"{bo}f4").tobytes()
            + B.astype(f"{bo}f4").tobytes()
            + q.astype(f"{bo}i2").tobytes()
        )
        samp_size = 2 * width
        n_hdr = n + 4
    elif int_kind:
        payload = data.astype(f"{bo}i2").tobytes()
        samp_size = 2 * width
        n_hdr = n
    else:
        payload = data.astype(f"{bo}f4").tobytes()
        samp_size = 4 * width
        n_hdr = n

    hdr = np.array([n_hdr, samp_period], dtype=f"{bo}i4").tobytes()
    hdr += np.array([samp_size, parm_kind], dtype=f"{bo}i2").tobytes()
    out = hdr + payload
    if with_crc:
        out += np.array([_crc16(payload)], dtype=f"{bo}u2").tobytes()
    with open(path, "wb") as f:
        f.write(out)


def read_htk_file(path: str, natural_order: bool = False) -> HTKFeatureFile:
    """Read an HTK feature file (HParm.c : OpenParmFile equivalent).

    Compressed files are decompressed; the returned parm_kind keeps the _C
    and _K bits so a rewrite reproduces the original encoding.
    """
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        HError(6310, "read_htk_file: cannot open %s (%s)", path, e)
    if len(raw) < 12:
        HError(6350, "read_htk_file: %s too short for HTK header", path)
    with contained(6350, "read_htk_file", path):
        return _parse_htk_file(raw, path, natural_order)


def _parse_htk_file(raw: bytes, path: str,
                    natural_order: bool) -> HTKFeatureFile:
    bo = "<" if natural_order else ">"
    n, samp_period = np.frombuffer(raw[:8], dtype=f"{bo}i4")
    samp_size, parm_kind = np.frombuffer(raw[8:12], dtype=f"{bo}i2")
    n, samp_period, samp_size, parm_kind = int(n), int(samp_period), int(samp_size), int(parm_kind)
    base = pk.base_kind(parm_kind)
    int_kind = base in (
        pk.BASE_KINDS.index("WAVEFORM"),
        pk.BASE_KINDS.index("IREFC"),
        pk.BASE_KINDS.index("DISCRETE"),
    )
    compressed = pk.has_qual(parm_kind, pk.HASCOMPX) and not int_kind
    with_crc = pk.has_qual(parm_kind, pk.HASCRCC)

    body = raw[12:]
    if with_crc:
        payload, crc_bytes = body[:-2], body[-2:]
        stored = int(np.frombuffer(crc_bytes, dtype=f"{bo}u2")[0])
        if _crc16(payload) != stored:
            HRError(6353, "read_htk_file: CRC mismatch in %s", path)
        body = payload

    if compressed:
        width = samp_size // 2
        nrows = n - 4
        A = np.frombuffer(body[: 4 * width], dtype=f"{bo}f4").astype(np.float64)
        B = np.frombuffer(body[4 * width : 8 * width], dtype=f"{bo}f4").astype(np.float64)
        q = np.frombuffer(body[8 * width : 8 * width + 2 * width * nrows], dtype=f"{bo}i2")
        q = q.reshape(nrows, width).astype(np.float64)
        data = ((q + B) / A).astype(np.float32)
    elif int_kind:
        width = samp_size // 2
        data = np.frombuffer(body[: 2 * width * n], dtype=f"{bo}i2").reshape(n, width)
        data = np.ascontiguousarray(data.astype(np.int16))
    else:
        width = samp_size // 4
        data = np.frombuffer(body[: 4 * width * n], dtype=f"{bo}f4").reshape(n, width)
        data = np.ascontiguousarray(data.astype(np.float32))
    return HTKFeatureFile(data=data, samp_period=samp_period, parm_kind=parm_kind)
