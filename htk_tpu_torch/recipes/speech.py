"""Synthetic speech for the port's demo corpus and chip checks.

`synth_speech` is a copy of `tests/golden/gen_mfcc_golden.py :
synth_speech` (Klatt-style source-filter synthesis: a glottal pulse train
with pitch declination and jitter through three time-varying formant
resonators at Peterson & Barney vowel targets, with breath noise), kept
here so that the port's demo corpus (recipes/demo.py) needs nothing
outside htk_tpu_torch. The same phones and seed give the same samples.

`synth_words`/`write_wav` are the corpus helpers of
`recipes/demo/make_corpus.py`, and `utterance_set` draws a set of longer
utterances over the same vowels (the chip check's HCopy set).
"""

import struct

import numpy as np

import numpy as np

FS = 16000.0

# Peterson & Barney (1952) average adult-male formant frequencies (Hz)
# and typical bandwidths (Hz).
VOWELS = {
    "aa": ([730.0, 1090.0, 2440.0], [80.0, 90.0, 120.0]),
    "iy": ([270.0, 2290.0, 3010.0], [60.0, 100.0, 150.0]),
    "uw": ([300.0, 870.0, 2240.0], [60.0, 80.0, 120.0]),
    "eh": ([530.0, 1840.0, 2480.0], [70.0, 90.0, 130.0]),
}


def synth_speech(phones, dur_s=0.18, trans_s=0.03, f0_start=125.0,
                 f0_end=90.0, seed=12345):
    """Source-filter synthesis with formant transitions.

    phones: list of vowel names or 'sil'.  dur_s: seconds per phone —
    a scalar or a per-phone sequence (variable durations make forced
    alignment non-trivial).  Returns float64 samples in int16 range.
    """
    rng = np.random.default_rng(seed)
    n_ph = len(phones)
    durs = np.full(n_ph, dur_s, float) if np.isscalar(dur_s) \
        else np.asarray(dur_s, float)
    bounds = np.concatenate([[0.0], np.cumsum(durs)])  # seconds
    n = int(bounds[-1] * FS)
    t_all = np.arange(n) / FS

    # piecewise-linear formant tracks with knots at phone centres;
    # silence keeps the neighbouring vowel's target (no discontinuity).
    def track(fidx, kind):
        knots_t = [(bounds[i] + bounds[i + 1]) / 2.0 for i in range(n_ph)]
        knots_v = [None if p == "sil" else VOWELS[p][kind][fidx]
                   for p in phones]
        vals = [v for v in knots_v if v is not None]
        prev = vals[0] if vals else 500.0
        filled = []
        for v in knots_v:
            if v is not None:
                prev = v
            filled.append(prev)
        nxt = filled[-1]
        for i in range(n_ph - 1, -1, -1):
            if knots_v[i] is not None:
                nxt = knots_v[i]
            filled[i] = filled[i] if knots_v[i] is not None else nxt
        return np.interp(t_all, knots_t, filled)

    f_tracks = [track(i, 0) for i in range(3)]
    b_tracks = [track(i, 1) for i in range(3)]

    # voicing amplitude envelope: raised-cosine on/offsets per phone
    voiced = np.zeros(n)
    for i, p in enumerate(phones):
        if p == "sil":
            continue
        s, e = int(bounds[i] * FS), int(bounds[i + 1] * FS)
        ramp = min(int(trans_s * FS), max(1, (e - s) // 2))
        seg = np.ones(e - s)
        r = 0.5 - 0.5 * np.cos(np.pi * np.arange(ramp) / ramp)
        seg[:ramp] = np.minimum(seg[:ramp], r)
        seg[-ramp:] = np.minimum(seg[-ramp:], r[::-1])
        voiced[s:e] = np.maximum(voiced[s:e], seg)

    # glottal source: impulse train at declining f0 with jitter, plus
    # -12 dB/oct spectral tilt (two-sample smoothing), plus breath noise
    f0 = f0_start + (f0_end - f0_start) * t_all / t_all[-1]
    f0 = f0 * (1.0 + 0.01 * rng.standard_normal(n).cumsum() / np.sqrt(n))
    phase = np.cumsum(f0 / FS)
    pulses = np.zeros(n)
    pulses[1:] = (np.floor(phase[1:]) - np.floor(phase[:-1])) > 0
    src = pulses * voiced
    for _ in range(2):  # tilt
        src[1:] = 0.5 * (src[1:] + src[:-1])
    src = src + 0.002 * rng.standard_normal(n) * (0.3 + voiced)

    # cascade formant resonators, coefficients per sample
    y = src
    for fi in range(3):
        F, Bw = f_tracks[fi], b_tracks[fi]
        C = -np.exp(-2.0 * np.pi * Bw / FS)
        B = 2.0 * np.exp(-np.pi * Bw / FS) * np.cos(2.0 * np.pi * F / FS)
        A = 1.0 - B - C
        out = np.zeros(n)
        y1 = y2 = 0.0
        for k in range(n):
            v = A[k] * y[k] + B[k] * y1 + C[k] * y2
            out[k] = v
            y2, y1 = y1, v
        y = out

    y = y / (np.max(np.abs(y)) + 1e-12) * 9000.0
    return np.round(y).astype(np.int16).astype(np.float64)


# --------------------------------------------------------------------------
# HTKBook-formula MFCC, per-frame scalar float64 (independent of htk_tpu)
# --------------------------------------------------------------------------




def synth_words(phs, rng):
    """One demo utterance: 80 ms silences, vowels of 120-220 ms drawn
    from `rng`, int16 samples (make_corpus.py : synth)."""
    durs = [0.08 if p == "sil" else float(rng.uniform(0.12, 0.22))
            for p in phs]
    x = synth_speech(phs, dur_s=durs, seed=int(rng.integers(1 << 31)))
    return x.astype(np.int16)


def write_wav(path, x, rate=16000):
    """16-bit mono RIFF WAV (make_corpus.py : write_wav)."""
    data = x.astype("<i2").tobytes()
    hdr = (
        b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
        + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, rate, 2 * rate, 2, 16)
        + b"data" + struct.pack("<I", len(data))
    )
    with open(path, "wb") as f:
        f.write(hdr + data)


def utterance_set(n, min_s=3.0, max_s=8.0, seed=0):
    """`n` int16 utterances of `min_s`-`max_s` seconds at 16 kHz: vowels
    of 120-220 ms between short silences, each length drawn uniformly."""
    rng = np.random.default_rng(seed)
    vowels = sorted(VOWELS)
    out = []
    for _ in range(n):
        target = float(rng.uniform(min_s, max_s))
        phs, durs, total = ["sil"], [0.1], 0.1
        while total < target - 0.1:
            d = float(rng.uniform(0.12, 0.22))
            phs.append(vowels[int(rng.integers(len(vowels)))])
            durs.append(d)
            total += d
            if rng.random() < 0.25:
                phs.append("sil")
                durs.append(0.08)
                total += 0.08
        phs.append("sil")
        durs.append(0.1)
        out.append(synth_speech(phs, dur_s=durs,
                                seed=int(rng.integers(1 << 31))
                                ).astype(np.int16))
    return out
