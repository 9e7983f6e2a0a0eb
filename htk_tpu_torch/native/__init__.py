"""The host runtime in C++ (htkio.cpp, htknative.cpp), loaded with ctypes.

The torch counterpart of `htk_tpu/native/__init__.py`, with the same
entry points, argtypes and return values:

  - libhtkio (htkio.cpp): the HTK feature-file codec (CRC16, `_C`
    decompression), the batch corpus loader behind
    `tools/_common.preload_corpus`, and the MLF structure scanner behind
    `io/mlf.MLF.read`.
  - libhtknative (htknative.cpp): the ARPA n-gram codec behind
    `io/lm.read_arpa`.

Both sources are byte-for-byte copies of htk_tpu's. Each builds at first
use with `g++ -O3 -std=c++17 -fPIC -shared` into csrc/_build/, keyed by
a hash of the source and the flags (utils/build.py, shared with the CUDA
kernels); nothing builds at import. Unlike htk_tpu, whose readers fall
back to their Python legs when the build fails, the port has one leg:
no compiler on PATH or a failed build raises HError 1094 with the
compiler's stderr, and no environment variable turns the codecs off.
`parse_arpa_plain` is the ARPA codec's plain version in Python, which
the tests and chip_smoke.py hold the codec against.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import threading
from typing import Dict, Optional

import numpy as np

from ..utils import build
from ..utils.errors import HError

_HERE = os.path.dirname(os.path.abspath(__file__))
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
# compiler seconds of each library's build in this process (0.0 when it
# was built already); chip_smoke.py prints them
BUILD_SECONDS: Dict[str, float] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _gxx() -> str:
    cc = shutil.which("g++")
    if cc is None:
        HError(1094, "native: no C++ compiler (g++) on PATH; the host "
                     "runtime (htk_tpu_torch/native/*.cpp) cannot build")
    return cc


def _source(name: str) -> str:
    """native/<name>.cpp: `htkio` or `htknative`."""
    return os.path.join(_HERE, f"{name}.cpp")


def library_path(name: str) -> str:
    """Where native/<name>.cpp's library is built."""
    return build.library_path(name, _source(name), HOST_FLAGS)


def _load(name: str, bind) -> ctypes.CDLL:
    """Build (once per source hash) and load native/<name>.cpp."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        try:
            path, BUILD_SECONDS[name] = build.build_library(
                name, _source(name), _gxx, HOST_FLAGS)
        except build.BuildFailed as e:
            HError(1094, "native: the host runtime did not build: %s", e)
        lib = ctypes.CDLL(path)
        bind(lib)
        _libs[name] = lib
        return lib


def _bind_htkio(lib: ctypes.CDLL) -> None:
    lib.htkio_crc16.restype = ctypes.c_uint16
    lib.htkio_crc16.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.htkio_load.restype = ctypes.c_int64
    lib.htkio_load.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.htkio_load_batch.restype = ctypes.c_int64
    lib.htkio_load_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.htkio_mlf_marks.restype = ctypes.c_int64
    lib.htkio_mlf_marks.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
    ]


def get_htkio() -> ctypes.CDLL:
    """The libhtkio handle, building it on first use (HError 1094 when it
    cannot build)."""
    return _load("htkio", _bind_htkio)


def load_corpus_batch(paths, max_frames: int, width: int):
    """Load many HTK feature files in one native call.

    Returns (arena (N, max_frames, width) f32, frames (N,) i64,
    periods (N,) i32, kinds (N,) i32). Files that fail to load report
    negative frame counts. `_C` payloads decompress in float32,
    (q + B) / A, as htk_tpu's codec does: within one float32 rounding of
    io/htkfeat.read_htk_file, which divides in float64.
    """
    lib = get_htkio()
    n = len(paths)
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    out = np.empty((n, max_frames, width), np.float32)
    periods = np.zeros(n, np.int32)
    kinds = np.zeros(n, np.int32)
    frames = np.zeros(n, np.int64)
    lib.htkio_load_batch(
        blob, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_frames, width,
        periods.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out, frames, periods, kinds


# ---------------------------------------------------------------------------
# ARPA n-gram codec (htknative.cpp)


def _bind_arpa(lib: ctypes.CDLL) -> None:
    lib.ht_arpa_parse.restype = ctypes.c_void_p
    lib.ht_arpa_parse.argtypes = [ctypes.c_char_p]
    lib.ht_arpa_error.restype = ctypes.c_char_p
    lib.ht_arpa_error.argtypes = [ctypes.c_void_p]
    lib.ht_arpa_order.restype = ctypes.c_int
    lib.ht_arpa_order.argtypes = [ctypes.c_void_p]
    lib.ht_arpa_nwords.restype = ctypes.c_int64
    lib.ht_arpa_nwords.argtypes = [ctypes.c_void_p]
    lib.ht_arpa_vocab_bytes.restype = ctypes.c_int64
    lib.ht_arpa_vocab_bytes.argtypes = [ctypes.c_void_p]
    lib.ht_arpa_copy_vocab.restype = None
    lib.ht_arpa_copy_vocab.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ht_arpa_count.restype = ctypes.c_int64
    lib.ht_arpa_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ht_arpa_copy.restype = None
    lib.ht_arpa_copy.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_void_p]
    lib.ht_arpa_free.restype = None
    lib.ht_arpa_free.argtypes = [ctypes.c_void_p]


def get_arpa_lib() -> ctypes.CDLL:
    """The ARPA codec library, building it on first use (HError 1094 when
    it cannot build)."""
    return _load("htknative", _bind_arpa)


def parse_arpa(path: str) -> Optional[dict]:
    """Parse an ARPA file natively.

    Returns None when the file cannot be opened or the codec rejects it
    (the caller's Python reader then reports the numbered error).
    Otherwise a dict:
      {"order": int, "vocab": list[str],
       n: (ids (count, n) uint32, logp (count,) f64 raw log10,
           bo (count,) f64 raw log10, has_bo (count,) bool)
       for n in 1..order with entries in file order}
    """
    lib = get_arpa_lib()
    h = lib.ht_arpa_parse(os.fsencode(path))
    if not h:
        return None
    try:
        err = lib.ht_arpa_error(h)
        if err:
            return None
        nw = lib.ht_arpa_nwords(h)
        blob = ctypes.create_string_buffer(
            max(1, int(lib.ht_arpa_vocab_bytes(h))))
        lib.ht_arpa_copy_vocab(h, blob)
        vocab = [w.decode("utf-8", errors="replace")
                 for w in blob.raw[:-1].split(b"\0")] if nw else []
        out = {"order": int(lib.ht_arpa_order(h)), "vocab": vocab}
        for n in range(1, out["order"] + 1):
            cnt = int(lib.ht_arpa_count(h, n))
            ids = np.empty((cnt, n), np.uint32)
            logp = np.empty(cnt, np.float64)
            bo = np.empty(cnt, np.float64)
            hb = np.empty(cnt, np.uint8)
            if cnt:
                lib.ht_arpa_copy(
                    h, n, ids.ctypes.data_as(ctypes.c_void_p),
                    logp.ctypes.data_as(ctypes.c_void_p),
                    bo.ctypes.data_as(ctypes.c_void_p),
                    hb.ctypes.data_as(ctypes.c_void_p))
            out[n] = (ids, logp, bo, hb.astype(bool))
        return out
    finally:
        lib.ht_arpa_free(h)


# the numbers std::from_chars takes whole (after one leading '+' is
# dropped): decimal with an optional exponent, inf, infinity, nan
_FROM_CHARS = re.compile(
    rb"-?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|(?i:inf|infinity|nan))")


def _from_chars(tok: bytes) -> Optional[float]:
    if tok[:1] == b"+":
        tok = tok[1:]
    return float(tok) if _FROM_CHARS.fullmatch(tok) else None


def parse_arpa_plain(path: str) -> Optional[dict]:
    """htknative.cpp's `ht_arpa_parse` in Python, line rule for line rule:
    the same dict as `parse_arpa`, every n-gram line kept in file order
    (a duplicated n-gram too), and None for the files it rejects."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    intern: Dict[bytes, int] = {}
    rows = {n: ([], [], [], []) for n in range(1, 5)}
    order, section = 1, 0
    for raw in data.split(b"\n"):
        line = raw.strip()
        if not line:
            continue
        if line[:1] == b"\\":
            if line.startswith(b"\\data\\"):
                section = -1
                continue
            if line[:8] in (b"\\1-grams", b"\\2-grams", b"\\3-grams",
                            b"\\4-grams"):
                section = line[1] - ord("0")
                order = max(order, section)
                continue
            if line.startswith(b"\\end\\"):
                break
            if section != 0 and b"-grams" in line:
                return None
        if section <= 0:
            continue
        f = line.split()
        if len(f) < section + 1:
            continue
        p = _from_chars(f[0])
        if p is None:
            return None
        b, hb = 0.0, False
        if len(f) >= section + 2:
            b = _from_chars(f[section + 1])
            if b is None:
                return None
            hb = True
        ids, lp, bo, has = rows[section]
        ids.append([intern.setdefault(w, len(intern))
                    for w in f[1:section + 1]])
        lp.append(p)
        bo.append(b)
        has.append(hb)
    out = {"order": order,
           "vocab": [w.decode("utf-8", errors="replace") for w in intern]}
    for n in range(1, order + 1):
        ids, lp, bo, has = rows[n]
        out[n] = (np.array(ids, np.uint32).reshape(len(ids), n),
                  np.array(lp, np.float64), np.array(bo, np.float64),
                  np.array(has, bool))
    return out
