"""The frontend's LPC-based kinds stage by stage, the port's against htk_tpu's.

Where the port's PLP, LPC and LPCEPSTRA first part from the reference's on
the same speech frames, and how far the Levinson-Durbin recursion carries
the difference. Each stage of ops/dsp.py's statics (windowed frames,
spectrum magnitudes, filterbank, autocorrelation, LPC, gain, cepstra) is
taken from both packages' own functions and tables on the same frames:
the reference's in float32 (as it runs), the port's in float32 and in
float64. The recursions are also run on the reference's own float32
autocorrelation, where the two packages' results are bit for bit equal.

    JAX_PLATFORMS=cpu python tests/_frontend_stages.py

prints, for each kind on the parity tests' speech, each stage's largest
difference over the stage's largest value, the Toeplitz condition number
of the worst frame's autocorrelation, and for every kind that
tests/test_torch_frontend.py holds relative to its scale, the largest
reference value and the absolute limits that follow.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from htk_tpu.io import parmkind as pk  # noqa: E402
from htk_tpu.ops import dsp as jdsp  # noqa: E402
from htk_tpu_torch.ops import dsp as tdsp  # noqa: E402
from htk_tpu_torch.recipes.speech import synth_speech  # noqa: E402

STAGES = ("win", "mag", "fbank", "autoc", "lpc", "E", "ceps")


def speech() -> np.ndarray:
    """The speech of tests/test_torch_frontend.py."""
    return synth_speech(["sil", "aa", "iy", "uw", "eh", "sil"],
                        seed=4).astype(np.float32)


def ar_noise() -> np.ndarray:
    """The AR(2) noise of tests/test_torch_frontend.py."""
    rng = np.random.default_rng(7)
    e = rng.normal(size=12000)
    x = np.zeros_like(e)
    for i in range(2, len(e)):
        x[i] = e[i] + 0.5 * x[i - 1] - 0.3 * x[i - 2]
    return (x * 1000).astype(np.float32)


def frames_of(wave: np.ndarray, kind: str) -> np.ndarray:
    cfg = jdsp.FrontendConfig(target_kind=pk.str2parmkind(kind))
    n = jdsp.num_frames(len(wave), cfg)
    idx = (np.arange(n)[:, None] * cfg.frame_shift
           + np.arange(cfg.frame_size)[None, :])
    return wave[idx]


def _stages(xp, frames, cfg, tbl, durbin, cepstra, asarray, rfft, mm):
    """ops/dsp.py's _statics_from_frames up to the cepstra, on either
    package's array type (both packages spell it alike)."""
    x = frames
    shifted = xp.concatenate([x[:, :1], x[:, :-1]], 1)
    x = (x - cfg.preem_coef * shifted) * asarray(tbl.hamming)
    mag = xp.abs(rfft(x, cfg.fft_n))
    out = {"win": x, "mag": mag}
    if cfg.base_str == "PLP":
        fbank = mm(mag * mag, asarray(tbl.mel_w))
        aspec = xp.maximum(fbank * asarray(tbl.eql)[None, :],
                           asarray(np.float32(1e-10))) ** cfg.comp_factor
        padded = xp.concatenate([aspec[:, :1], aspec, aspec[:, -1:]], 1)
        out["fbank"] = fbank
        autoc = mm(padded, asarray(tbl.plp_idft))
    else:
        n = x.shape[1]
        autoc = xp.stack([xp.sum(x[:, : n - k] * x[:, k:], 1)
                          for k in range(cfg.lpc_order + 1)], 1)
    out["autoc"] = autoc
    out["lpc"], out["E"] = durbin(autoc, cfg.lpc_order)
    out["ceps"] = cepstra(out["lpc"], cfg.num_ceps)
    return out


def reference_stages(frames: np.ndarray, kind: str) -> dict:
    cfg = jdsp.FrontendConfig(target_kind=pk.str2parmkind(kind))
    out = _stages(jnp, jnp.asarray(frames), cfg, jdsp._tables(cfg),
                  jdsp._durbin,
                  lambda a, n: jdsp._lpc_to_cepstra(a, n, None),
                  jnp.asarray,
                  lambda x, n: jnp.fft.rfft(x, n=n, axis=1),
                  lambda a, b: jnp.matmul(a, b, precision="highest"))
    return {k: np.asarray(v) for k, v in out.items()}


def port_stages(frames: np.ndarray, kind: str, dtype) -> dict:
    cfg = tdsp.FrontendConfig(target_kind=pk.str2parmkind(kind))

    def asarray(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    class _Torch:
        abs, stack = staticmethod(torch.abs), staticmethod(torch.stack)
        concatenate = staticmethod(torch.cat)
        maximum = staticmethod(torch.maximum)

        @staticmethod
        def sum(x, dim):
            return torch.sum(x, dim=dim)

    out = _stages(_Torch, asarray(frames), cfg, tdsp._tables(cfg),
                  tdsp._durbin, tdsp._lpc_to_cepstra, asarray,
                  lambda x, n: torch.fft.rfft(x, n=n, dim=-1), torch.matmul)
    return {k: v.numpy() for k, v in out.items()}


def recursions_on(autoc: np.ndarray, kind: str):
    """Durbin and the cepstra of both packages on the same float32
    autocorrelation: ((port lpc, E, ceps), (reference lpc, E, ceps))."""
    cfg = jdsp.FrontendConfig(target_kind=pk.str2parmkind(kind))
    a_t, e_t = tdsp._durbin(torch.tensor(autoc), cfg.lpc_order)
    a_j, e_j = jdsp._durbin(jnp.asarray(autoc), cfg.lpc_order)
    c_t = tdsp._lpc_to_cepstra(a_t, cfg.num_ceps)
    c_j = jdsp._lpc_to_cepstra(a_j, cfg.num_ceps, None)
    return ((a_t.numpy(), e_t.numpy(), c_t.numpy()),
            tuple(np.asarray(v) for v in (a_j, e_j, c_j)))


def rel(a: np.ndarray, b: np.ndarray) -> float:
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def worst_condition(autoc: np.ndarray, order: int) -> float:
    """The largest Toeplitz condition number over the frames."""
    i = np.abs(np.arange(order)[:, None] - np.arange(order)[None, :])
    return max(float(np.linalg.cond(r[i])) for r in autoc)


def main() -> None:
    torch.set_num_threads(1)
    wave = speech()
    for kind in ("PLP", "LPCEPSTRA"):
        frames = frames_of(wave, kind)
        ref = reference_stages(frames, kind)
        p32 = port_stages(frames, kind, torch.float32)
        p64 = port_stages(frames.astype(np.float64), kind, torch.float64)
        print(f"{kind} on the speech ({len(frames)} frames): largest "
              f"difference over the stage's largest value")
        for k in STAGES:
            if k in ref:
                print(f"  {k:5s} port f32 vs ref f32 {rel(p32[k], ref[k]):.3g}"
                      f"   ref f32 vs port f64 {rel(ref[k], p64[k]):.3g}"
                      f"   largest |value| {np.abs(p64[k]).max():.4g}")
        got, want = recursions_on(ref["autoc"], kind)
        same = all(np.array_equal(g, w) for g, w in zip(got, want))
        print(f"  Durbin and cepstra on the reference's f32 autocorrelation:"
              f" {'bit for bit equal' if same else 'DIFFER'}")
        cfg = jdsp.FrontendConfig(target_kind=pk.str2parmkind(kind))
        print(f"  worst frame's Toeplitz condition number "
              f"{worst_condition(p64['autoc'], cfg.lpc_order):.3g}")
    print("kinds held relative to their scale: largest |reference value| "
          "and the absolute limits that follow")
    from _torch_compare import FE_REL_MAX, FE_REL_MEAN

    for name, wave, kinds in (
            ("speech", speech(), ("MELSPEC", "MELSPEC_E", "PLP_E_D_A",
                                  "PLP_0", "PLP_E_N_D_A_Z")),
            ("AR(2) noise", ar_noise(), ("LPCEPSTRA", "LPCEPSTRA_E_D_A",
                                         "LPCEPSTRA_0_Z"))):
        for kind in kinds:
            ref = jdsp.compute_features(wave, jdsp.FrontendConfig(
                target_kind=pk.str2parmkind(kind)))
            s = float(np.abs(ref).max())
            print(f"  {name:11s} {kind:15s} {s:.6g}: max {FE_REL_MAX * s:.3g},"
                  f" mean {FE_REL_MEAN * s:.3g}")


if __name__ == "__main__":
    main()
