"""Shared tool plumbing: data-file opening, precision, device.

The port's tools run on the CUDA card. The environment variable
`HTK_TPU_TORCH_DEVICE=cpu` asks for the CPU instead (the tests do); with
no card and no such request a tool stops with HError 1090.

The torch counterpart of `htk_tpu/tools/_common.py`. HTK and ESIG
feature files and waveforms open as in htk_tpu; a waveform runs through
the port's frontend (ops/dsp.py) on the tool's device. A live HAUDIO
source raises HError 6373: live audio (htk_tpu's io/audio.py) is not
ported yet. htk_tpu's `preload_corpus` is not carried over: it only feeds
the native batch codec, which the port leaves out, so every file goes
through the numpy reader, which gives the same data. Nor are
`channel_config`, whose one caller is HERest -r (not ported yet), and
`source_kind`, which has no caller.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..io import parmkind as pk
from ..io.htkfeat import read_htk_file
from ..io.scp import parse_scp_entry
from ..io.wavefile import read_wave
from ..ops.dsp import FrontendConfig, compute_features
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


class DeferredWave:
    """A waveform read whose frontend run is deferred for batching.

    open_speech_file(defer_frontend=True) returns this instead of
    features when the source resolves to a waveform; the caller collects
    a chunk of these and runs ops/dsp.compute_features_batch over them
    (HCopy's corpus-preparation path)."""

    __slots__ = ("samples", "fcfg", "entry", "feats")

    def __init__(self, samples, fcfg, entry):
        self.samples = samples
        self.fcfg = fcfg
        self.entry = entry
        self.feats = None  # filled by the batch extraction pass


def open_speech_file(entry: str, cfg: Config, defer_frontend: bool = False):
    """Open a data file as (features, samp_period, parm_kind, scp entry).

    The HParm OpenBuffer role for HTK-format and ESIG feature files and
    waveforms, with optional segment selection from the scp entry and
    HPARMFILTER/HWAVEFILTER input filters. A waveform converts per
    TARGETKIND on `default_device()`; with
    defer_frontend=True it returns a DeferredWave (samples + frontend
    config) instead — see compute_features_batch.
    """
    e = parse_scp_entry(entry)
    src_kind = cfg.str_("SOURCEKIND", "ANON", module="HPARM").upper()
    if src_kind == "HAUDIO":
        HError(6373, "open_speech_file: HAUDIO (live audio) sources are "
                     "not yet ported to htk_tpu_torch")
    src_fmt_c = (cfg.str_("SOURCEFORMAT", "HTK", module="HWAVE") or "HTK").upper()
    # HShell xxFILTER channels: feature reads go through HPARMFILTER,
    # waveform reads through HWAVEFILTER — only the channel actually
    # opened runs its filter (HShell.c FOpen channel table)
    from ..utils.filters import cleanup, maybe_filter

    ppath = ptmp = None
    wtmp = None

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
            src_fmt = cfg.str_("SOURCEFORMAT", "HTK", module="HWAVE") or "HTK"
            src_rate = cfg.int_("SOURCERATE", 0, module="HWAVE") or cfg.int_(
                "SOURCERATE", 0, module="HPARM"
            )
            wpath, wtmp = maybe_filter(e.physical, "HWAVEFILTER", cfg)
            wv = read_wave(wpath, fmt=src_fmt, source_rate=src_rate or None)
            samples = wv.samples
            if e.start is not None:
                samples = samples[e.start : e.end + 1]
            fcfg = FrontendConfig.from_config(cfg, wv.samp_period)
            if defer_frontend:
                return DeferredWave(samples, fcfg, e)
            feats = compute_features(samples, fcfg, device=default_device())
            period = int(fcfg.target_rate)
            return feats, period, fcfg.target_kind & ~(pk.HASCOMPX | pk.HASCRCC), e
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
        cleanup(wtmp)

