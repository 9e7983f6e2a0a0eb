"""Shared tool plumbing: data-file opening, precision, device.

The port's tools run on the CUDA card. The environment variable
`HTK_TPU_TORCH_DEVICE=cpu` asks for the CPU instead (the tests do); with
no card and no such request a tool stops with HError 1090.

The torch counterpart of `htk_tpu/tools/_common.py` for feature-file
sources. HTK and ESIG feature files open as in htk_tpu; a waveform or
HAUDIO source raises HError 6373, because the frontend (htk_tpu's
ops/dsp.py) is not ported yet. htk_tpu's `preload_corpus` is not
carried over: it only feeds the native batch codec, which the port leaves
out, so every file goes through the numpy reader, which gives the same
data.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..io import parmkind as pk
from ..io.htkfeat import read_htk_file
from ..io.scp import parse_scp_entry
from ..utils.config import Config
from ..utils.errors import HError


def outp_precision(cfg: Config) -> str:
    """Matmul precision for OutP: `HTKTPU: PRECISION = highest|high|default`.

    highest (the default) is full fp32 with TF32 off; high and default
    turn TF32 on for the Gaussian matmul (ops/outp.matmul_precision)."""
    p = (cfg.str_("PRECISION", "highest", module="HTKTPU")
         or "highest").lower()
    if p not in ("highest", "high", "default"):
        HError(1019, "HTKTPU: PRECISION must be highest|high|default "
               "(got %s)", p)
    return p


DEVICE_ENV = "HTK_TPU_TORCH_DEVICE"


def default_device() -> torch.device:
    """The tool's device: `cuda`, or `cpu` when the caller asks for it with
    HTK_TPU_TORCH_DEVICE=cpu. Raises HError 1090 when no card is visible
    and the CPU was not asked for, and 1019 on another value."""
    want = (os.environ.get(DEVICE_ENV) or "cuda").strip().lower()
    if want == "cpu":
        return torch.device("cpu")
    if want != "cuda":
        HError(1019, "%s must be cuda or cpu (got %s)", DEVICE_ENV, want)
    if not torch.cuda.is_available():
        HError(1090, "no CUDA card is visible; set %s=cpu to run on the "
                     "CPU", DEVICE_ENV)
    return torch.device("cuda")


def _not_ported(what: str):
    HError(6373, "open_speech_file: %s sources need the frontend "
                 "(ops/dsp.py), not yet ported to htk_tpu_torch", what)


def open_speech_file(entry: str, cfg: Config):
    """Open a feature file as (features, samp_period, parm_kind, scp entry).

    The HParm OpenBuffer role for HTK-format and ESIG feature files, with
    optional segment selection from the scp entry and HPARMFILTER input
    filters.
    """
    e = parse_scp_entry(entry)
    src_kind = cfg.str_("SOURCEKIND", "ANON", module="HPARM").upper()
    if src_kind == "HAUDIO":
        _not_ported("HAUDIO (live audio)")
    src_fmt_c = (cfg.str_("SOURCEFORMAT", "HTK", module="HWAVE") or "HTK").upper()
    from ..utils.filters import cleanup, maybe_filter

    ppath = ptmp = None

    def parm_path():
        nonlocal ppath, ptmp
        if ppath is None:
            ppath, ptmp = maybe_filter(e.physical, "HPARMFILTER", cfg)
        return ppath

    try:
        if src_kind == "ANON":
            # HTK's ANON: take the kind from the file itself (peek at the
            # 12-byte header, raw first, then through HPARMFILTER);
            # non-HTK formats imply WAVEFORM
            src_kind = "WAVEFORM"
            if src_fmt_c == "HTK":
                for path_fn in (lambda: e.physical, parm_path):
                    try:
                        with open(path_fn(), "rb") as f:
                            hdr = f.read(12)
                        kind_code = int(
                            np.frombuffer(hdr[10:12], dtype=">i2")[0])
                        src_kind = pk.BASE_KINDS[pk.base_kind(kind_code)]
                        break
                    except Exception:
                        continue
        if pk.base_kind(pk.str2parmkind(src_kind)) == pk.BASE_KINDS.index("WAVEFORM"):
            _not_ported("waveform")
        if src_fmt_c in ("ESIG", "ESIGNAL"):
            # ESIG feature file: the kind comes from SOURCEKIND (USER when
            # unspecified), as HParm requires for Entropic inputs
            from ..io.esignal import read_esig

            ef = read_esig(parm_path())
            data = ef.data.astype(np.float32)
            if e.start is not None:
                data = data[e.start : e.end + 1]
            kind = pk.str2parmkind(
                src_kind if src_kind not in ("ANON", "WAVEFORM") else "USER")
            return data, ef.samp_period or 100000, kind, e
        ff = read_htk_file(parm_path())
        data = ff.data
        if e.start is not None:
            data = data[e.start : e.end + 1]
        return data, ff.samp_period, ff.parm_kind & ~(pk.HASCOMPX | pk.HASCRCC), e
    finally:
        cleanup(ptmp)

