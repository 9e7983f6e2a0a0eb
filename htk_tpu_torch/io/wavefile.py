"""Waveform file I/O.

Mirrors `HTKLib/HWave.c` (OpenWaveInput/GetWaveData/OpenWaveOutput): reads
audio in the formats the north-star recipes touch — HTK, WAV(E) RIFF,
NIST/SPHERE, NOHEAD raw — and writes HTK/WAV. Sample periods are in HTK's
100 ns units. Samples are returned as int16 mono numpy arrays (HTK reads
16-bit linear; multi-channel WAVs take channel 0, matching HWave's
single-channel model).

Reads HTK, WAV, NIST/SPHERE, AIFF, SUNAU8 (.au incl. mu-law), ESPS,
TIMIT/OGI prototype-CD headers, SDES1, SCRIBE (headerless) and raw
audio, plus ESIG waveforms via io/esignal.py; writes HTK and WAV.
The TIMIT/OGI/SDES1/ESIG header layouts are [LC] pending the reference.

Copied from `htk_tpu/io/wavefile.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot import htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..utils.errors import HError, contained
from . import parmkind as pk
from .htkfeat import read_htk_file, write_htk_file

FORMATS = ["HTK", "WAV", "WAVE", "NIST", "SPHERE", "AIFF", "SUNAU8",
           "ESPS", "TIMIT", "OGI", "SDES1", "SCRIBE", "NOHEAD", "RAW",
           "ALIEN"]


@dataclass
class Waveform:
    samples: np.ndarray  # int16, shape (n,)
    samp_period: int  # 100ns units


def _read_wav_riff(raw: bytes, path: str) -> Waveform:
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        HError(6250, "ReadWave: %s is not a RIFF/WAVE file", path)
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos : pos + 4]
        (size,) = struct.unpack("<I", raw[pos + 4 : pos + 8])
        chunk = raw[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", chunk[:16])
        elif cid == b"data":
            data = chunk
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        HError(6251, "ReadWave: %s missing fmt/data chunk", path)
    audio_fmt, nchan, rate, _, _, bits = fmt
    if audio_fmt not in (1, 0xFFFE) or bits != 16:
        HError(6252, "ReadWave: %s: only 16-bit PCM WAV supported (fmt=%d bits=%d)",
               path, audio_fmt, bits)
    x = np.frombuffer(data, dtype="<i2")
    if nchan > 1:
        x = x[::nchan]
    return Waveform(np.ascontiguousarray(x), int(round(1e7 / rate)))


def _read_nist(raw: bytes, path: str) -> Waveform:
    if not raw.startswith(b"NIST_1A"):
        HError(6253, "ReadWave: %s is not a NIST/SPHERE file", path)
    hdr_size = int(raw[8:16].split()[0])
    hdr = raw[:hdr_size].decode("ascii", errors="replace")
    fields = {}
    for line in hdr.splitlines():
        parts = line.split()
        if len(parts) >= 3 and parts[1].startswith("-"):
            fields[parts[0]] = parts[2]
    rate = int(fields.get("sample_rate", "16000"))
    nbytes = int(fields.get("sample_n_bytes", "2"))
    if nbytes != 2:
        HError(6254, "ReadWave: %s: only 2-byte NIST samples supported", path)
    coding = fields.get("sample_coding", "pcm")
    if "ulaw" in coding:
        HError(6254, "ReadWave: %s: ulaw NIST not supported", path)
    byte_fmt = fields.get("sample_byte_format", "01")
    dt = "<i2" if byte_fmt == "01" else ">i2"
    x = np.frombuffer(raw[hdr_size:], dtype=dt).astype(np.int16)
    return Waveform(np.ascontiguousarray(x), int(round(1e7 / rate)))


def _read_aiff(raw: bytes, path: str) -> Waveform:
    """AIFF (big-endian IFF): COMM rate (80-bit float) + SSND samples."""
    if raw[:4] != b"FORM" or raw[8:12] != b"AIFF":
        HError(6255, "ReadWave: %s is not an AIFF file", path)
    pos = 12
    rate = None
    nchan = 1
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos : pos + 4]
        (size,) = struct.unpack(">I", raw[pos + 4 : pos + 8])
        chunk = raw[pos + 8 : pos + 8 + size]
        if cid == b"COMM":
            nchan, _nframes, bits = struct.unpack(">HIH", chunk[:8])
            if bits != 16:
                HError(6252, "ReadWave: %s: only 16-bit AIFF supported", path)
            # 80-bit IEEE 754 extended float sample rate
            exp = struct.unpack(">H", chunk[8:10])[0]
            mant = struct.unpack(">Q", chunk[10:18])[0]
            rate = mant * 2.0 ** (exp - 16383 - 63)
        elif cid == b"SSND":
            (offset, _block) = struct.unpack(">II", chunk[:8])
            data = chunk[8 + offset :]
        pos += 8 + size + (size & 1)
    if rate is None or data is None:
        HError(6251, "ReadWave: %s missing COMM/SSND chunk", path)
    x = np.frombuffer(data, dtype=">i2").astype(np.int16)
    if nchan > 1:
        x = x[::nchan]
    return Waveform(np.ascontiguousarray(x), int(round(1e7 / rate)))


def _read_sunau(raw: bytes, path: str) -> Waveform:
    """Sun/NeXT .au (SUNAU8): 24-byte header, ulaw or 16-bit linear."""
    if raw[:4] != b".snd":
        HError(6256, "ReadWave: %s is not a Sun audio file", path)
    off, _size, enc, rate, _chan = struct.unpack(">IIIII", raw[4:24])
    body = raw[off:]
    if enc == 1:  # 8-bit mu-law
        u = np.frombuffer(body, dtype=np.uint8)
        u = ~u
        sign = np.where(u & 0x80, -1, 1)
        exp = (u >> 4) & 0x07
        mant = u & 0x0F
        x = sign * (((mant.astype(np.int32) << 3) + 0x84) << exp) - sign * 0x84
        x = np.clip(x, -32768, 32767).astype(np.int16)
    elif enc == 3:  # 16-bit linear
        x = np.frombuffer(body, dtype=">i2").astype(np.int16)
    else:
        HError(6254, "ReadWave: %s: unsupported .au encoding %d", path, enc)
    return Waveform(np.ascontiguousarray(x), int(round(1e7 / rate)))


def _read_esps(raw: bytes, path: str) -> Waveform:
    """ESPS .sd sampled-data file: fixed 333-byte preamble + header. [LC]

    Reads the common 16-bit case: the record start offset lives at bytes
    8-12 of the preamble; sample rate defaults to 16 kHz when the generic
    header item can't be located (ESPS headers are notoriously free-form).
    """
    if len(raw) < 40:
        HError(6257, "ReadWave: %s too short for ESPS header", path)
    (hdr_size,) = struct.unpack("<i", raw[8:12])
    if not (40 <= hdr_size < len(raw)):
        (hdr_size,) = struct.unpack(">i", raw[8:12])
    if not (40 <= hdr_size < len(raw)):
        HError(6257, "ReadWave: %s: cannot locate ESPS data offset", path)
    x = np.frombuffer(raw[hdr_size:], dtype="<i2").astype(np.int16)
    return Waveform(np.ascontiguousarray(x), 625)


def _read_timit(raw: bytes, path: str, big_endian: bool) -> Waveform:
    """TIMIT prototype-CD / OGI header: 12 bytes of six int16 fields
    (hdrSize, version, numChannels, sampRate/256?, nSamples as int32 in
    the last two) followed by 16-bit PCM. TIMIT is little-endian, OGI is
    the big-endian variant. Field layout reconstructed from HTKBook's
    format table; byte-check against HWave.c when the reference lands.
    [LC]"""
    if len(raw) < 12:
        HError(6257, "ReadWave: %s too short for TIMIT/OGI header", path)
    e = ">" if big_endian else "<"
    hdr_size, _ver, _chan, _rate = struct.unpack(e + "4h", raw[:8])
    (n_samp,) = struct.unpack(e + "i", raw[8:12])
    off = hdr_size if 12 <= hdr_size < len(raw) else 12
    x = np.frombuffer(raw[off:], dtype=e + "i2").astype(np.int16)
    if 0 < n_samp <= len(x):
        x = x[:n_samp]
    return Waveform(np.ascontiguousarray(x), 625)  # 16 kHz corpora


def _read_sdes1(raw: bytes, path: str) -> Waveform:
    """Sound Designer I: 1336-byte Mac header then big-endian 16-bit PCM;
    the sample rate field is not parsed (HTK-era SD1 audio is 16 kHz
    unless SOURCERATE overrides). [LC]"""
    if len(raw) <= 1336:
        HError(6257, "ReadWave: %s too short for SDES1 header", path)
    x = np.frombuffer(raw[1336:], dtype=">i2").astype(np.int16)
    return Waveform(np.ascontiguousarray(x), 625)


def read_wave(
    path: str,
    fmt: str = "HTK",
    source_rate: Optional[int] = None,
    natural_order: bool = False,
) -> Waveform:
    """Read a waveform file (HWave.c : OpenWaveInput/GetWaveData).

    `fmt` follows the SOURCEFORMAT config value. `source_rate` (100 ns
    units, the SOURCERATE config) is required for headerless formats.
    """
    fmt = fmt.upper()
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        HError(6210, "ReadWave: cannot open %s (%s)", path, e)
    with contained(6253, "ReadWave", path):
        return _dispatch_wave(raw, path, fmt, source_rate, natural_order)


def _dispatch_wave(raw: bytes, path: str, fmt: str,
                   source_rate, natural_order) -> Waveform:
    if fmt in ("WAV", "WAVE"):
        return _read_wav_riff(raw, path)
    if fmt in ("NIST", "SPHERE"):
        return _read_nist(raw, path)
    if fmt == "AIFF":
        return _read_aiff(raw, path)
    if fmt in ("SUNAU8", "AU", "SND"):
        return _read_sunau(raw, path)
    if fmt == "ESPS":
        return _read_esps(raw, path)
    if fmt == "TIMIT":
        w = _read_timit(raw, path, big_endian=False)
        return Waveform(w.samples, int(source_rate) if source_rate
                        else w.samp_period)
    if fmt == "OGI":
        w = _read_timit(raw, path, big_endian=True)
        return Waveform(w.samples, int(source_rate) if source_rate
                        else w.samp_period)
    if fmt == "SDES1":
        w = _read_sdes1(raw, path)
        return Waveform(w.samples, int(source_rate) if source_rate
                        else w.samp_period)
    if fmt in ("NOHEAD", "RAW", "SCRIBE"):
        # SCRIBE (UK SCRIBE CD-ROM) is headerless 16-bit PCM — same read
        # path as NOHEAD with SOURCERATE supplying the period
        if not source_rate:
            HError(6230, "ReadWave: SOURCERATE required for %s input %s",
                   fmt, path)
        dt = "<i2" if natural_order else ">i2"
        return Waveform(np.frombuffer(raw, dtype=dt).astype(np.int16), int(source_rate))
    if fmt in ("ESIG", "ESIGNAL"):
        from .esignal import read_esig

        ef = read_esig(path)
        period = ef.samp_period or (int(source_rate) if source_rate else 0)
        if not period:
            HError(6230, "ReadWave: ESIG %s has no recordFreq and no "
                         "SOURCERATE", path)
        return Waveform(ef.data.reshape(-1).astype(np.int16), period)
    if fmt == "HTK":
        ff = read_htk_file(path, natural_order=natural_order)
        if pk.base_kind(ff.parm_kind) != pk.BASE_KINDS.index("WAVEFORM"):
            HError(6231, "ReadWave: %s is not a WAVEFORM HTK file (%s)", path, ff.kind_str)
        return Waveform(ff.data.reshape(-1).astype(np.int16), ff.samp_period)
    HError(6270, "ReadWave: unsupported SOURCEFORMAT %s", fmt)


def write_wave(path: str, wave: Waveform, fmt: str = "HTK") -> None:
    """Write a waveform file (HWave.c : OpenWaveOutput/PutWaveSample)."""
    fmt = fmt.upper()
    if fmt == "HTK":
        write_htk_file(
            path,
            wave.samples.reshape(-1, 1),
            wave.samp_period,
            pk.str2parmkind("WAVEFORM"),
        )
        return
    if fmt in ("WAV", "WAVE"):
        rate = int(round(1e7 / wave.samp_period))
        data = wave.samples.astype("<i2").tobytes()
        hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
        hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2, 2, 16)
        hdr += b"data" + struct.pack("<I", len(data))
        with open(path, "wb") as f:
            f.write(hdr + data)
        return
    HError(6270, "WriteWave: unsupported TARGETFORMAT %s", fmt)
