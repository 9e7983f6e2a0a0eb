"""Shared tool plumbing: data-file opening, precision, device, the
decoders' retry ladder.

The port's tools run on the CUDA card. The environment variable
`HTK_TPU_TORCH_DEVICE=cpu` asks for the CPU instead (the tests do); with
no card and no such request a tool stops with HError 1090.

The torch counterpart of `htk_tpu/tools/_common.py`. HTK and ESIG
feature files and waveforms open as in htk_tpu; a waveform runs through
the port's frontend (ops/dsp.py) on the tool's device, and so does a
live HAUDIO source (io/audio.py), pulled dry first. `preload_corpus`
loads a corpus's `_C` feature files in one call to the port's copy of
the native batch codec (native/htkio.cpp), as htk_tpu's does; the tools
that call it in htk_tpu call it here and take every other file through
`open_speech_file`. `source_kind`, which has no caller, is not carried
over. `channel_config` (HERest -r's channel views) is copied as it is.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ..io import parmkind as pk
from ..io.audio import open_audio_input
from ..io.htkfeat import _header_fits, read_htk_file
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


def _retry_ladder(gen_beam, max_act, cfg: Config):
    """The HFB.c-style retry escalation, decoder side, as (beam, max
    active) steps for an utterance whose pruned decode found no path: the
    beam widened by HREC: PRUNERETRYINC (default 200) twice, then
    unpruned."""
    inc = cfg.flt_("PRUNERETRYINC", 200.0, module="HREC")
    ladder = ([(gen_beam + inc, max_act), (gen_beam + 2 * inc, max_act)]
              if gen_beam is not None and inc > 0 else [])
    ladder.append((None, None))
    return ladder


DEVICE_ENV = "HTK_TPU_TORCH_DEVICE"


def default_device() -> torch.device:
    """The tool's device: `cuda`, or `cpu` when the caller asks for it with
    HTK_TPU_TORCH_DEVICE=cpu. In a multi-rank run (WORLD_SIZE above 1, as
    torchrun sets it) each rank owns the card `cuda:LOCAL_RANK`. Raises
    HError 1090 when no card is visible and the CPU was not asked for,
    1091 when LOCAL_RANK names a card that is not there (NCCL refuses two
    ranks on one card), and 1019 on another value."""
    want = (os.environ.get(DEVICE_ENV) or "cuda").strip().lower()
    if want == "cpu":
        return torch.device("cpu")
    if want != "cuda":
        HError(1019, "%s must be cuda or cpu (got %s)", DEVICE_ENV, want)
    if not torch.cuda.is_available():
        HError(1090, "no CUDA card is visible; set %s=cpu to run on the "
                     "CPU", DEVICE_ENV)
    local = os.environ.get("LOCAL_RANK", "").strip()
    if not local or int(os.environ.get("WORLD_SIZE") or 1) <= 1:
        return torch.device("cuda")
    n = torch.cuda.device_count()
    if int(local) >= n:
        HError(1091, "LOCAL_RANK %s has no card of its own: %d visible",
               local, n)
    return torch.device("cuda", int(local))


def channel_config(cfg: Config, n: int) -> Config:
    """Single-pass-retraining channel view (HERest -r).

    HParm.c's dual-channel configuration: entries qualified HPARM1:/
    HWAVE1: apply to the alignment channel, HPARM2:/HWAVE2: to the
    update channel. This returns a Config where channel-n entries are
    promoted into HPARM/HWAVE, so the ordinary open_speech_file path
    reads that channel.
    """
    out = Config(entries=dict(cfg.entries), sources=list(cfg.sources))
    for (mod, name), val in cfg.entries.items():
        if mod in (f"HPARM{n}", f"HWAVE{n}"):
            out.entries[(mod[:-1], name)] = val
    return out


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

    The HParm OpenBuffer role for HTK-format and ESIG feature files,
    waveforms and live HAUDIO sources, with optional segment selection
    from the scp entry and HPARMFILTER/HWAVEFILTER input filters. A
    waveform or live source converts per TARGETKIND on
    `default_device()`; with defer_frontend=True a waveform returns a
    DeferredWave (samples + frontend config) instead — see
    compute_features_batch.
    """
    e = parse_scp_entry(entry)
    src_kind = cfg.str_("SOURCEKIND", "ANON", module="HPARM").upper()
    if src_kind == "HAUDIO":
        # live capture (HParm live buffer): pull the audio source dry,
        # then convert like a waveform file. The scp entry (if any)
        # overrides HAUDIO:AUDIOSOURCE as the replay file — HCopy's
        # "record then convert" live mode.
        src = open_audio_input(
            cfg, fname=(e.physical if e.physical else None))
        src.start()
        parts = []
        while (c := src.read(16000)) is not None:
            parts.append(c)
        src.stop()
        samples = np.concatenate(parts) if parts else np.zeros(0, np.int16)
        fcfg = FrontendConfig.from_config(cfg, src.samp_period)
        feats = compute_features(samples.astype(np.float32), fcfg,
                                 device=default_device())
        period = int(fcfg.target_rate)
        return (feats, period,
                fcfg.target_kind & ~(pk.HASCOMPX | pk.HASCRCC), e)
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


def preload_corpus(entries: List[str], cfg: Config) -> dict:
    """Batch-load `_C`-compressed HTK feature corpora natively.

    Returns {entry: (data, period, kind, scp_entry)} for the files it
    covered; callers fall through to open_speech_file for the rest
    (waves, uncompressed floats — where numpy's SIMD byteswap already
    wins — segment-sliced entries, filters, ESIG). The
    `HTKLib/HParm.c : OpenBuffer` role at corpus scale: one C call
    decompresses a whole chunk (native/htkio.cpp), in float32 as
    htk_tpu's codec does (native.load_corpus_batch).
    """
    out: dict = {}
    if cfg is None or cfg.str_("HPARMFILTER", None):
        return out
    if cfg.str_("SOURCEKIND", "ANON", module="HPARM").upper() != "ANON":
        return out
    if (cfg.str_("SOURCEFORMAT", "HTK", module="HWAVE") or
            "HTK").upper() != "HTK":
        return out
    from ..native import load_corpus_batch

    groups: dict = {}
    seen: set = set()
    budget = 2 << 30  # cap resident decompressed features at ~2 GB;
    # everything past the cap streams through open_speech_file as before
    for ent in entries:
        if ent in seen or not isinstance(ent, str):
            continue
        seen.add(ent)
        if budget <= 0:
            continue
        e = parse_scp_entry(ent)
        if e.start is not None:
            continue
        try:
            with open(e.physical, "rb") as f:
                hdr = f.read(12)
        except OSError:
            continue
        if len(hdr) < 12:
            continue
        n = int(np.frombuffer(hdr[:4], dtype=">i4")[0])
        samp_size = int(np.frombuffer(hdr[8:10], dtype=">i2")[0])
        kind = int(np.frombuffer(hdr[10:12], dtype=">i2")[0])
        base = pk.base_kind(kind)
        if base >= len(pk.BASE_KINDS):
            continue  # no such kind: open_speech_file reports it
        if base in (pk.BASE_KINDS.index("WAVEFORM"),
                    pk.BASE_KINDS.index("IREFC"),
                    pk.BASE_KINDS.index("DISCRETE")):
            continue
        if not pk.has_qual(kind, pk.HASCOMPX) or samp_size <= 0 or n <= 4:
            continue
        if not _header_fits(e.physical, n, samp_size, kind):
            continue  # damaged: open_speech_file reports it
        width = samp_size // 2
        budget -= n * width * 4
        groups.setdefault(width, []).append((ent, e, n))

    CHUNK = 512
    for width, items in groups.items():
        for i0 in range(0, len(items), CHUNK):
            chunk = items[i0 : i0 + CHUNK]
            max_frames = max(n for _ent, _e, n in chunk)
            arena, frames, periods, kinds = load_corpus_batch(
                [c[1].physical for c in chunk], max_frames, width)
            for k, (ent, e, _n) in enumerate(chunk):
                if frames[k] < 0:
                    continue  # damaged file: open_speech_file reports it
                out[ent] = (
                    np.ascontiguousarray(arena[k, : int(frames[k])]),
                    int(periods[k]),
                    int(kinds[k]) & ~(pk.HASCOMPX | pk.HASCRCC),
                    e,
                )
    return out
