"""The feature-extraction frontend (HTK HParm/HSigP semantics) in torch.

The PyTorch counterpart of `htk_tpu/ops/dsp.py`. It replaces the per-frame
scalar pipeline of `HTKLib/HParm.c : ConvertFrame()` and `HTKLib/HSigP.c`
(PreEmphasise/Ham/Wave2FBank/FBank2MFCC/WeightCepstrum) with one
whole-utterance computation over a batch of padded utterances:

  frames(B, T, win) -> preemph -> window -> |rFFT| -> mel (matmul)
  -> log -> DCT (matmul) -> lifter -> [+c0/+E] -> deltas/accs
  -> CMN/energy-norm (per-file reductions over the real frames)

Every stage is an ordinary torch op on the device the caller names (no
hand-written kernel: the reference's frontend is plain XLA too). The
matmuls run with TF32 off (ops/outp.matmul_precision), as the
reference's run at precision "highest". The kinds that run Levinson-
Durbin (PLP, LPC, LPCEPSTRA) are computed in float64 from the frames on
and returned as float32: the recursion is ill-conditioned in float32 on
speech with sharp formant peaks (PLP on the golden fixture,
tests/golden: 1.85e-3 max |diff| in float32, 2.1e-4 in float64, the
reference's float32 6.8e-4; measured on the CPU). The other kinds run
in float32, as the reference's do.

`FrontendConfig` and the numpy table builders (mel filterbank, VTLN warp,
DCT, lifter, equal loudness, PLP IDFT, regression) are copied unchanged
from the reference: the mel filterbank and DCT are built on the host in
float64 exactly per HTK's InitFBank formulas, then cast to float32.
Dither (`_dithered`) is numpy, bit for bit the reference's.

A file's frames pad to a bucket (`_bucket_len`) and a batch to a fixed
width of 64 rows, so a file's features do not depend on which other files
share its chunk.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..io import parmkind as pk
from ..utils.config import Config
from ..utils.errors import HError
from .outp import matmul_precision


@dataclass(frozen=True)
class FrontendConfig:
    """Static frontend parameters (the HPARM config surface).

    Field names follow the HTK config keys they mirror.
    """

    target_kind: int = pk.str2parmkind("MFCC_E_D_A")  # TARGETKIND
    samp_period: int = 625  # SOURCERATE, 100ns units (625 = 16 kHz)
    window_size: float = 250000.0  # WINDOWSIZE, 100ns
    target_rate: float = 100000.0  # TARGETRATE (frame shift), 100ns
    preem_coef: float = 0.97  # PREEMCOEF
    use_hamming: bool = True  # USEHAMMING
    zmean_source: bool = False  # ZMEANSOURCE (per-frame DC removal)
    raw_energy: bool = True  # RAWENERGY
    num_chans: int = 20  # NUMCHANS
    num_ceps: int = 12  # NUMCEPS
    cep_lifter: int = 22  # CEPLIFTER
    enormalise: bool = True  # ENORMALISE
    escale: float = 0.1  # ESCALE
    sil_floor: float = 50.0  # SILFLOOR (dB)
    delta_window: int = 2  # DELTAWINDOW
    acc_window: int = 2  # ACCWINDOW
    third_window: int = 2  # THIRDWINDOW
    lo_freq: float = -1.0  # LOFREQ
    hi_freq: float = -1.0  # HIFREQ
    use_power: bool = False  # USEPOWER
    add_dither: float = 0.0  # ADDDITHER (uniform +-d, fixed seed)
    simple_diffs: bool = False  # SIMPLEDIFFS
    lpc_order: int = 12  # LPCORDER (PLP)
    comp_factor: float = 0.33  # COMPRESSFACT (PLP cube-root)
    warp_freq: float = 1.0  # WARPFREQ (VTLN warp factor; 1.0 = off)
    warp_lcut: float = 0.0  # WARPLCUTOFF (Hz)
    warp_ucut: float = 0.0  # WARPUCUTOFF (Hz; 0 -> 0.8 * top [LC])

    @classmethod
    def from_config(cls, cfg: Config, samp_period: int) -> "FrontendConfig":
        m = "HPARM"
        kind_s = cfg.str_("TARGETKIND", "MFCC_E_D_A", module=m)
        return cls(
            target_kind=pk.str2parmkind(kind_s),
            samp_period=samp_period,
            window_size=cfg.flt_("WINDOWSIZE", 250000.0, module=m),
            target_rate=cfg.flt_("TARGETRATE", 100000.0, module=m),
            preem_coef=cfg.flt_("PREEMCOEF", 0.97, module=m),
            use_hamming=cfg.bool_("USEHAMMING", True, module=m),
            zmean_source=cfg.bool_("ZMEANSOURCE", False, module=m),
            raw_energy=cfg.bool_("RAWENERGY", True, module=m),
            num_chans=cfg.int_("NUMCHANS", 20, module=m),
            num_ceps=cfg.int_("NUMCEPS", 12, module=m),
            cep_lifter=cfg.int_("CEPLIFTER", 22, module=m),
            enormalise=cfg.bool_("ENORMALISE", True, module=m),
            escale=cfg.flt_("ESCALE", 0.1, module=m),
            sil_floor=cfg.flt_("SILFLOOR", 50.0, module=m),
            delta_window=cfg.int_("DELTAWINDOW", 2, module=m),
            acc_window=cfg.int_("ACCWINDOW", 2, module=m),
            third_window=cfg.int_("THIRDWINDOW", 2, module=m),
            lo_freq=cfg.flt_("LOFREQ", -1.0, module=m),
            hi_freq=cfg.flt_("HIFREQ", -1.0, module=m),
            use_power=cfg.bool_("USEPOWER", False, module=m),
            simple_diffs=cfg.bool_("SIMPLEDIFFS", False, module=m),
            lpc_order=cfg.int_("LPCORDER", 12, module=m),
            comp_factor=cfg.flt_("COMPRESSFACT", 0.33, module=m),
            add_dither=cfg.flt_("ADDDITHER", 0.0, module=m),
            warp_freq=cfg.flt_("WARPFREQ", 1.0, module=m),
            warp_lcut=cfg.flt_("WARPLCUTOFF", 0.0, module=m),
            warp_ucut=cfg.flt_("WARPUCUTOFF", 0.0, module=m),
        )

    # -- derived static geometry ----------------------------------------

    @property
    def frame_size(self) -> int:
        return int(self.window_size / self.samp_period + 0.5)

    @property
    def frame_shift(self) -> int:
        return int(self.target_rate / self.samp_period + 0.5)

    @property
    def fft_n(self) -> int:
        n = 2
        while n < self.frame_size:
            n *= 2
        return n

    @property
    def base(self) -> int:
        return pk.base_kind(self.target_kind)

    @property
    def base_str(self) -> str:
        return pk.BASE_KINDS[self.base]

    def n_static(self) -> int:
        """Static coefficients per frame (before _N suppression)."""
        if self.base_str in ("FBANK", "MELSPEC"):
            n = self.num_chans
        elif self.base_str in ("MFCC", "PLP", "LPCEPSTRA"):
            n = self.num_ceps
        elif self.base_str == "LPC":
            n = self.lpc_order
        else:
            HError(6320, "Frontend: unsupported TARGETKIND base %s", self.base_str)
        if pk.has_qual(self.target_kind, pk.HASZEROC):
            n += 1
        if pk.has_qual(self.target_kind, pk.HASENERGY):
            n += 1
        return n

    def n_blocks(self) -> int:
        n = 1
        if pk.has_qual(self.target_kind, pk.HASDELTA):
            n += 1
        if pk.has_qual(self.target_kind, pk.HASACCS):
            n += 1
        if pk.has_qual(self.target_kind, pk.HASTHIRD):
            n += 1
        return n

    def width(self) -> int:
        w = self.n_static() * self.n_blocks()
        if pk.has_qual(self.target_kind, pk.HASNULLE):
            w -= 1
        return w


# ---------------------------------------------------------------------------
# Host-side precomputed tables (HSigP.c : InitFBank / FBank2MFCC tables)
# ---------------------------------------------------------------------------


def _mel(freq_hz: float) -> float:
    return 1127.0 * math.log(1.0 + freq_hz / 700.0)


def _warp_freq(f: float, fl: float, fu: float, alpha: float,
               min_f: float, max_f: float) -> float:
    """Piecewise-linear VTLN frequency warp (HTKBook 5.10 / HSigP.c
    WarpFreq [LC — boundary-piece coefficients follow the published
    endpoint-preserving form]): slope 1/alpha inside [cl, cu], linear
    boundary pieces pinning W(min_f) = min_f and W(max_f) = max_f."""
    if alpha == 1.0:
        return f
    scale = 1.0 / alpha
    cu = fu * 2.0 / (1.0 + scale)
    cl = fl * 2.0 / (1.0 + scale)
    if f > cu and max_f > cu:
        au = (max_f - cu * scale) / (max_f - cu)
        return au * (f - cu) + scale * cu
    if f < cl and cl > min_f:
        al = (cl * scale - min_f) / (cl - min_f)
        return al * (f - min_f) + min_f
    return scale * f


def mel_weight_matrix(cfg: FrontendConfig) -> np.ndarray:
    """Triangular mel filterbank as an (n_rfft_bins, num_chans) matrix.

    Reproduces HSigP.c : InitFBank()'s loChan/loWt tables and
    Wave2FBank()'s accumulation, recast as a single matrix so the binning
    runs as one MXU matmul over all frames. Row j corresponds to rfft bin
    j (0-based; HTK's 1-based "bin k" = rfft bin k-1).
    """
    fft_n = cfg.fft_n
    nby2 = fft_n // 2
    fs = 1.0e7 / cfg.samp_period
    fres = 1.0e7 / (cfg.samp_period * fft_n * 700.0)
    max_chan = cfg.num_chans + 1

    klo, khi = 2, nby2
    mlo = 0.0
    mhi = 1127.0 * math.log(1.0 + (nby2 + 1 - 1) * fres)
    if cfg.lo_freq >= 0.0:
        mlo = _mel(cfg.lo_freq)
        klo = max(2, int(cfg.lo_freq * cfg.samp_period * 1.0e-7 * fft_n + 2.5))
    if cfg.hi_freq > 0.0:
        mhi = _mel(cfg.hi_freq)
        khi = min(nby2, int(cfg.hi_freq * cfg.samp_period * 1.0e-7 * fft_n + 0.5))

    # channel centres, uniformly spaced in mel between mlo and mhi
    cf = np.zeros(max_chan + 1)
    for chan in range(1, max_chan + 1):
        cf[chan] = (chan / max_chan) * (mhi - mlo) + mlo
    if cfg.warp_freq != 1.0:
        # VTLN (WARPFREQ): warp the channel centres' linear frequency,
        # endpoints pinned so the analysis band is unchanged
        min_f = max(cfg.lo_freq, 0.0)
        max_f = cfg.hi_freq if cfg.hi_freq > 0 else fs / 2.0
        fu = cfg.warp_ucut if cfg.warp_ucut > 0 else 0.8 * max_f
        fl = max(cfg.warp_lcut, min_f)
        for chan in range(1, max_chan + 1):
            f_hz = 700.0 * (math.exp(cf[chan] / 1127.0) - 1.0)
            cf[chan] = _mel(_warp_freq(f_hz, fl, fu, cfg.warp_freq,
                                       min_f, max_f))

    # loChan: highest centre at or below each bin's mel frequency
    lo_chan = np.full(nby2 + 1, -1, dtype=np.int64)
    chan = 1
    for k in range(1, nby2 + 1):
        melk = 1127.0 * math.log(1.0 + (k - 1) * fres)
        if klo <= k <= khi:
            while chan <= max_chan and cf[chan] < melk:
                chan += 1
            lo_chan[k] = chan - 1

    lo_wt = np.zeros(nby2 + 1)
    for k in range(1, nby2 + 1):
        c = lo_chan[k]
        if klo <= k <= khi:
            melk = 1127.0 * math.log(1.0 + (k - 1) * fres)
            if c > 0:
                lo_wt[k] = (cf[c + 1] - melk) / (cf[c + 1] - cf[c])
            else:
                lo_wt[k] = (cf[1] - melk) / (cf[1] - mlo)

    # scatter into matrix over rfft bins 0..nby2 (HTK never uses DC/Nyquist)
    W = np.zeros((nby2 + 1, cfg.num_chans))
    for k in range(klo, khi + 1):
        c = lo_chan[k]
        j = k - 1  # rfft bin index
        if c > 0:
            W[j, c - 1] += lo_wt[k]
        if c < cfg.num_chans:
            W[j, c] += 1.0 - lo_wt[k]
    return W.astype(np.float32)


def dct_matrix(num_chans: int, num_ceps: int) -> np.ndarray:
    """(num_chans, num_ceps) DCT per HSigP.c : FBank2MFCC()."""
    mfnorm = math.sqrt(2.0 / num_chans)
    M = np.zeros((num_chans, num_ceps))
    for j in range(1, num_ceps + 1):
        x = j * math.pi / num_chans
        for k in range(1, num_chans + 1):
            M[k - 1, j - 1] = mfnorm * math.cos(x * (k - 0.5))
    return M.astype(np.float32)


def lifter_vector(num_ceps: int, L: int) -> np.ndarray:
    """Cepstral liftering weights per HSigP.c : GenCepWin/WeightCepstrum."""
    if L <= 0:
        return np.ones(num_ceps, dtype=np.float32)
    j = np.arange(1, num_ceps + 1)
    return (1.0 + (L / 2.0) * np.sin(math.pi * j / L)).astype(np.float32)


def equal_loudness(cfg: FrontendConfig) -> np.ndarray:
    """Equal-loudness weights at the mel channel centres (HSigP InitPLP)."""
    fft_n = cfg.fft_n
    nby2 = fft_n // 2
    fres = 1.0e7 / (cfg.samp_period * fft_n * 700.0)
    max_chan = cfg.num_chans + 1
    mlo = _mel(cfg.lo_freq) if cfg.lo_freq >= 0 else 0.0
    mhi = (_mel(cfg.hi_freq) if cfg.hi_freq > 0
           else 1127.0 * math.log(1.0 + nby2 * fres))
    eql = np.zeros(cfg.num_chans)
    for chan in range(1, cfg.num_chans + 1):
        cf_mel = (chan / max_chan) * (mhi - mlo) + mlo
        f_hz = 700.0 * (math.exp(cf_mel / 1127.0) - 1.0)
        fsq = f_hz * f_hz
        fsub = fsq / (fsq + 1.6e5)
        eql[chan - 1] = fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))
    return eql.astype(np.float32)


def plp_idft_matrix(num_chans: int, lpc_order: int) -> np.ndarray:
    """(num_chans+2, lpc_order+1) IDFT for auditory-spectrum -> autocorr.

    HSigP InitPLP's cosine table over the symmetrised 2*(numChans+1)-point
    spectrum (edge channels duplicated).
    """
    n_auto = lpc_order + 1
    pts = num_chans + 2  # with duplicated edges
    twoN = 2.0 * (num_chans + 1)
    M = np.zeros((pts, n_auto))
    for i in range(n_auto):
        for j in range(pts):
            w = 1.0 if j in (0, pts - 1) else 2.0
            M[j, i] = w * math.cos(math.pi * i * j / (num_chans + 1))
    return (M / twoN).astype(np.float32)


def _durbin(autoc: torch.Tensor, order: int):
    """Levinson-Durbin over frames: autoc (..., order+1) -> (lpc (..., order),
    E (...)).

    HSigP.c Durbin(), vectorised over frames with a Python loop over the
    (small, static) order; each coefficient is a (...,) tensor."""
    E = autoc[..., 0]
    a = [None] * (order + 1)  # a[1..order]
    for i in range(1, order + 1):
        acc = autoc[..., i]
        for j in range(1, i):
            acc = acc - a[j] * autoc[..., i - j]
        k = acc / torch.clamp(E, min=1e-20)
        new_a = list(a)
        new_a[i] = k
        for j in range(1, i):
            new_a[j] = a[j] - k * a[i - j]
        a = new_a
        E = E * (1.0 - k * k)
    return torch.stack(a[1:], dim=-1), E


def _lpc_to_cepstra(lpc: torch.Tensor, n_ceps: int):
    """LPC -> cepstra (HSigP.c LPC2Cepstrum):

      c[n] = -(a[n] + (1/n) sum_{i=1..n-1} (n-i) a[i] c[n-i]),  a[n>p] = 0
    """
    p = lpc.shape[-1]
    c = [None] * (n_ceps + 1)
    for n in range(1, n_ceps + 1):
        acc = lpc[..., n - 1] if n <= p else torch.zeros_like(lpc[..., 0])
        for i in range(1, min(n, p + 1)):
            acc = acc + ((n - i) / n) * lpc[..., i - 1] * c[n - i]
        c[n] = -acc
    return torch.stack(c[1:], dim=-1)


def regression_matrix(n_frames: int, win: int, simple_diffs: bool = False) -> np.ndarray:
    """(T, T) matrix R with deltas = R @ x (HParm.c : Regress()).

    d_t = sum_{th=1..win} th*(x_{t+th} - x_{t-th}) / (2*sum th^2), with
    boundary frames replicated (index clamping), matching HTK's file-mode
    behaviour. simple_diffs uses (x_{t+th}-x_{t-th})/(2*win) instead.
    """
    R = np.zeros((n_frames, n_frames))
    if simple_diffs:
        norm = 2.0 * win
        for t in range(n_frames):
            for th in range(1, win + 1):
                hi = min(n_frames - 1, t + th)
                lo = max(0, t - th)
                R[t, hi] += 1.0 / norm
                R[t, lo] -= 1.0 / norm
    else:
        sigma2 = 2.0 * sum(th * th for th in range(1, win + 1))
        for t in range(n_frames):
            for th in range(1, win + 1):
                hi = min(n_frames - 1, t + th)
                lo = max(0, t - th)
                R[t, hi] += th / sigma2
                R[t, lo] -= th / sigma2
    return R.astype(np.float32)


# ---------------------------------------------------------------------------
# Device pipeline
# ---------------------------------------------------------------------------


def num_frames(n_samples: int, cfg: FrontendConfig) -> int:
    """HParm frame count: ((nSamples - frameSize) / frameShift) + 1."""
    if n_samples < cfg.frame_size:
        return 0
    return (n_samples - cfg.frame_size) // cfg.frame_shift + 1


def _frame_signal(x: torch.Tensor, frame_size: int, frame_shift: int,
                  n_frames: int) -> torch.Tensor:
    """(B, N) samples -> (B, n_frames, frame_size) overlapping frames."""
    return x.unfold(-1, frame_size, frame_shift)[:, :n_frames]


def _delta_block(x: torch.Tensor, win: int, simple: bool) -> torch.Tensor:
    """HTK regression along time for a (B, T, D) block, edge frames
    replicated (HParm.c : Regress())."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)
    acc = torch.zeros_like(x)
    for th in range(1, win + 1):
        hi = torch.clamp(t + th, 0, T - 1)
        lo = torch.clamp(t - th, 0, T - 1)
        acc = acc + (1 if simple else th) * (x[:, hi] - x[:, lo])
    if simple:
        return acc / (2.0 * win)
    return acc / (2.0 * sum(th * th for th in range(1, win + 1)))


@dataclass(frozen=True)
class _Tables:
    mel_w: np.ndarray
    dct: np.ndarray
    lifter: np.ndarray
    hamming: np.ndarray
    eql: np.ndarray
    plp_idft: np.ndarray


@functools.lru_cache(maxsize=64)
def _tables(cfg: FrontendConfig) -> _Tables:
    fs = cfg.frame_size
    a = 2.0 * math.pi / (fs - 1)
    ham = (0.54 - 0.46 * np.cos(a * np.arange(fs))).astype(np.float32)
    return _Tables(
        mel_w=mel_weight_matrix(cfg),
        dct=dct_matrix(cfg.num_chans, cfg.num_ceps),
        lifter=lifter_vector(cfg.num_ceps, cfg.cep_lifter),
        hamming=ham,
        eql=equal_loudness(cfg),
        plp_idft=plp_idft_matrix(cfg.num_chans, cfg.lpc_order),
    )


@functools.lru_cache(maxsize=64)
def _dev_tables(cfg: FrontendConfig, device: torch.device,
                dtype: torch.dtype) -> _Tables:
    """The tables as `dtype` tensors on `device`, built once each."""
    tbl = _tables(cfg)
    return _Tables(**{k: torch.as_tensor(v, device=device, dtype=dtype)
                      for k, v in tbl.__dict__.items()})


# kinds whose Levinson-Durbin recursion is ill-conditioned in float32 on
# speech with sharp formant peaks: computed in float64 from the frames on
_FLOAT64_KINDS = ("PLP", "LPC", "LPCEPSTRA")


def _statics_from_frames(frames: torch.Tensor, cfg: FrontendConfig,
                         tbl: _Tables):
    """frames (B, T, frame_size) -> statics (B, T, n_static) and the raw
    log energy (B, T), in the frames' dtype.

    Follows HParm.c ConvertFrame order: zmean -> rawE -> preemph -> window
    -> spectrum -> mel -> log -> DCT -> lifter -> c0/E append.
    """
    x = frames
    if cfg.zmean_source:
        x = x - torch.mean(x, dim=-1, keepdim=True)

    raw_e = torch.sum(x * x, dim=-1)

    if cfg.preem_coef != 0.0:
        # PreEmphasise: s[j] -= k*s[j-1] (descending, so original values);
        # s[0] *= 1-k falls out of pairing s[0] with itself in the shift.
        shifted = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
        x = x - cfg.preem_coef * shifted
    if cfg.use_hamming:
        x = x * tbl.hamming

    win_e = torch.sum(x * x, dim=-1)
    log_e = torch.log(torch.clamp(raw_e if cfg.raw_energy else win_e,
                                  min=1e-20))

    base = cfg.base_str
    spec = torch.fft.rfft(x, n=cfg.fft_n, dim=-1)
    mag = torch.abs(spec)  # (B, T, fft_n//2+1)
    # PLP always uses the power spectrum (HParm.c forces usePower for PLP)
    if cfg.use_power or base == "PLP":
        mag = mag * mag

    fbank = torch.matmul(mag, tbl.mel_w)
    log_fbank = torch.log(torch.clamp(fbank, min=1.0))  # melFloor = 1.0

    gain = None  # LPC/PLP model gain, used for _0
    cols = []
    if base == "MELSPEC":
        cols.append(fbank)
    elif base == "FBANK":
        cols.append(log_fbank)
    elif base == "MFCC":
        cols.append(torch.matmul(log_fbank, tbl.dct) * tbl.lifter)
    elif base == "PLP":
        # HSigP.c FBank2PLP: equal loudness -> cube-root compression ->
        # IDFT to autocorrelation -> Durbin -> LPC cepstra -> lifter
        aspec = fbank * tbl.eql
        aspec = torch.pow(torch.clamp(aspec, min=1e-10), cfg.comp_factor)
        padded = torch.cat([aspec[..., :1], aspec, aspec[..., -1:]], dim=-1)
        autoc = torch.matmul(padded, tbl.plp_idft)  # (B, T, p+1)
        lpc, E = _durbin(autoc, cfg.lpc_order)
        cols.append(_lpc_to_cepstra(lpc, cfg.num_ceps) * tbl.lifter)
        gain = torch.log(torch.clamp(E, min=1e-20))
    elif base in ("LPC", "LPCEPSTRA"):
        # time-domain autocorrelation of the windowed frame (Wave2LPC)
        p = cfg.lpc_order
        n = x.shape[-1]
        autoc = torch.stack(
            [torch.sum(x[..., : n - k] * x[..., k:], dim=-1)
             for k in range(p + 1)], dim=-1)
        lpc, E = _durbin(autoc, p)
        if base == "LPC":
            cols.append(lpc)
        else:
            cols.append(_lpc_to_cepstra(lpc, cfg.num_ceps) * tbl.lifter)
        gain = torch.log(torch.clamp(E, min=1e-20))
    else:
        HError(6320, "Frontend: TARGETKIND base %s not yet device-supported",
               base)

    if pk.has_qual(cfg.target_kind, pk.HASZEROC):
        if gain is not None:
            c0 = gain[..., None]
        else:
            mfnorm = math.sqrt(2.0 / cfg.num_chans)
            c0 = torch.sum(log_fbank, dim=-1, keepdim=True) * mfnorm
        cols.append(c0)
    if pk.has_qual(cfg.target_kind, pk.HASENERGY):
        cols.append(log_e[..., None])
    return torch.cat(cols, dim=-1), log_e


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, T, D) with each batch row's frames reordered by idx (B, T)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _qualify(statics: torch.Tensor, cfg: FrontendConfig,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply _E normalisation, _Z CMN, _D/_A/_T, _N to (B, T, D) statics.

    `valid` is an optional (B, T) bool mask marking real (non-padding)
    frames; per-file reductions (CMN mean, energy max) respect it.
    """
    B, T = statics.shape[0], statics.shape[1]
    if valid is None:
        valid = torch.ones((B, T), dtype=torch.bool, device=statics.device)
    vf = valid.to(statics.dtype)[..., None]
    nvalid = torch.clamp(torch.sum(vf, dim=1), min=1.0)  # (B, 1)

    has_e = pk.has_qual(cfg.target_kind, pk.HASENERGY)
    has_0 = pk.has_qual(cfg.target_kind, pk.HASZEROC)
    x = statics

    # _Z: cepstral mean subtraction over the file, statics except energy
    # (energy is handled by ENORMALISE; HParm.c MeanNormalise behaviour).
    if pk.has_qual(cfg.target_kind, pk.HASZEROM):
        ncep = x.shape[-1] - (1 if has_e else 0)
        mean = torch.sum(x[..., :ncep] * vf, dim=1) / nvalid
        x = torch.cat([x[..., :ncep] - mean[:, None, :], x[..., ncep:]],
                      dim=-1)

    # ENORMALISE: e' = 1.0 - (emax - e)*escale with silence floor (HParm.c)
    if has_e and cfg.enormalise:
        e = x[..., -1]
        emax = torch.amax(torch.where(valid, e, -math.inf), dim=1,
                          keepdim=True)
        emin = emax - (cfg.sil_floor * math.log(10.0)) / 10.0
        e = torch.maximum(e, emin)
        e = 1.0 - (emax - e) * cfg.escale
        x = torch.cat([x[..., :-1], e[..., None]], dim=-1)

    # Padding rows must replicate the last *valid* row before every
    # regression stage, otherwise the next stage's boundary clamp reads
    # stale values through the padding (HTK clamps at the true last frame).
    n_real = torch.sum(valid.to(torch.int64), dim=1, keepdim=True)
    last = torch.minimum(torch.arange(T, device=x.device)[None, :],
                         torch.clamp(n_real - 1, min=0))

    blocks = [x]
    if pk.has_qual(cfg.target_kind, pk.HASDELTA):
        d = _rows(_delta_block(blocks[-1], cfg.delta_window,
                               cfg.simple_diffs), last)
        blocks.append(d)
        if pk.has_qual(cfg.target_kind, pk.HASACCS):
            a = _rows(_delta_block(d, cfg.acc_window, cfg.simple_diffs),
                      last)
            blocks.append(a)
            if pk.has_qual(cfg.target_kind, pk.HASTHIRD):
                t3 = _rows(_delta_block(a, cfg.third_window,
                                        cfg.simple_diffs), last)
                blocks.append(t3)
    out = torch.cat(blocks, dim=-1)

    if pk.has_qual(cfg.target_kind, pk.HASNULLE):
        # _N: suppress absolute energy (or c0 if no _E) from the statics
        if not (has_e or has_0):
            HError(6321, "Frontend: _N requires _E or _0")
        drop = cfg.n_static() - 1  # energy (or c0) is the last static column
        out = torch.cat([out[..., :drop], out[..., drop + 1:]], dim=-1)
    return out


def _bucket_len(n: int) -> int:
    """Round frame counts up to a few bucket lengths (the reference's
    retrace limit; here it fixes the shapes a file is computed at)."""
    b = 32
    while b < n:
        b = b * 2 if b < 512 else b + 256
    return b


def _extract_impl(samples: torch.Tensor, n_frames_real: torch.Tensor,
                  cfg: FrontendConfig, n_frames_pad: int) -> torch.Tensor:
    """(B, need) padded float32 samples and (B,) real frame counts on one
    device -> (B, n_frames_pad, width) float32 features."""
    dtype = (torch.float64 if cfg.base_str in _FLOAT64_KINDS
             else torch.float32)
    tbl = _dev_tables(cfg, samples.device, dtype)
    frames = _frame_signal(samples.to(dtype), cfg.frame_size,
                           cfg.frame_shift, n_frames_pad)
    with matmul_precision("highest"):
        statics, _ = _statics_from_frames(frames, cfg, tbl)
        t = torch.arange(n_frames_pad, device=samples.device)[None, :]
        valid = t < n_frames_real[:, None]
        # Replicate the last real frame into the padding rows so the delta
        # regression's boundary clamp (HParm replicates edge frames) holds
        # at the real end of the utterance; per-file reductions use `valid`.
        last = torch.minimum(t, n_frames_real[:, None] - 1)
        return _qualify(_rows(statics, last), cfg,
                        valid=valid).to(torch.float32)


def _dithered(samples: np.ndarray, cfg: FrontendConfig) -> np.ndarray:
    samples = np.asarray(samples, dtype=np.float32)
    if cfg.add_dither > 0.0 and len(samples):
        rng = np.random.default_rng(12345)
        samples = samples + cfg.add_dither * (
            2.0 * rng.random(len(samples), dtype=np.float32) - 1.0)
    return samples


def compute_features(samples: np.ndarray, cfg: FrontendConfig, *,
                     device) -> np.ndarray:
    """Waveform (int16/float) -> HTK feature matrix (T, width) float32,
    computed on `device`.

    The single-utterance entry (HCopy's per-file path). The frame count
    pads to a bucket, as the batched path's does, so both compute a file
    at the same shapes.
    """
    # HParm ADDDITHER: +-d uniform noise so digital silence never hits
    # log(0). HTK draws from rand(); a fixed-seed generator keeps the
    # features reproducible run to run.
    samples = _dithered(samples, cfg)
    T = num_frames(len(samples), cfg)
    if T < 1:
        HError(6322, "Frontend: utterance too short (%d samples)",
               len(samples))
    Tp = _bucket_len(T)
    need = (Tp - 1) * cfg.frame_shift + cfg.frame_size
    padded = np.zeros((1, need), dtype=np.float32)
    # trailing samples past the last full frame belong to NO frame (T is
    # the frame count), so truncating to the padded buffer is exact —
    # len(samples) can exceed `need` when T lands exactly on a bucket
    n_copy = min(len(samples), need)
    padded[0, :n_copy] = samples[:n_copy]
    out = _extract_impl(torch.as_tensor(padded, device=device),
                        torch.tensor([T], device=device), cfg, Tp)
    return out[0, :T].cpu().numpy()


BATCH_WIDTH = 64  # rows of one batched frontend call


def compute_features_batch(jobs, *, device) -> list:
    """Batched wave->features on `device`: `jobs` is [(samples, cfg), ...];
    returns the per-job feature matrices in order.

    Files group by (cfg, frame bucket) and each group runs in chunks of
    BATCH_WIDTH rows, one call each, padded with dummy rows to the FIXED
    width: a file's output values do not depend on which other files
    share its scp chunk, and the shapes a call sees are few.
    """
    outs: list = [None] * len(jobs)
    groups: dict = {}
    for i, (samples, cfg) in enumerate(jobs):
        s = _dithered(samples, cfg)
        T = num_frames(len(s), cfg)
        if T < 1:
            HError(6322, "Frontend: utterance too short (%d samples)",
                   len(s))
        groups.setdefault((cfg, _bucket_len(T)), []).append((i, s, T))
    for (cfg, Tp), items in groups.items():
        need = (Tp - 1) * cfg.frame_shift + cfg.frame_size
        Bp = BATCH_WIDTH
        for i0 in range(0, len(items), Bp):
            chunk = items[i0 : i0 + Bp]
            buf = np.zeros((Bp, need), np.float32)
            ts = np.ones(Bp, np.int64)  # dummy rows: one valid frame
            for b, (_i, s, T) in enumerate(chunk):
                n_copy = min(len(s), need)  # see compute_features
                buf[b, :n_copy] = s[:n_copy]
                ts[b] = T
            out = _extract_impl(torch.as_tensor(buf, device=device),
                                torch.as_tensor(ts, device=device), cfg,
                                Tp).cpu().numpy()
            for b, (i, _s, T) in enumerate(chunk):
                outs[i] = out[b, :T]
    return outs
