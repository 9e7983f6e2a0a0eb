"""The port's frontend (htk_tpu_torch/ops/dsp.py) against htk_tpu's, on the CPU.

The same numpy-seeded waveforms go through htk_tpu.ops.dsp (jax) and the
port's torch version. Tolerance: max |diff| <= 1e-3 and mean |diff| <=
2e-5 (tests/_torch_compare.py). Kinds with a scale of their own are held
at 5e-5 (max) and 2e-6 (mean) of their largest reference value: MELSPEC's
linear filterbank magnitudes (up to 2.4e5 on the speech, where one
float32 ulp is 0.016) and the liftered LPC cepstra of PLP and LPCEPSTRA.

The port runs PLP, LPC and LPCEPSTRA in float64 from the frames on, the
reference in float32. tests/_frontend_stages.py takes both apart stage by
stage on the speech: the two packages first part at the spectrum (rfft
and the matmuls round differently, 2e-7 of the largest value), their
Durbin and cepstrum recursions are bit for bit equal on the same float32
autocorrelation, and the recursion carries the 2e-7 into the cepstra.
For PLP (autocorrelation condition number ~60) that makes 1.7e-5 of the
largest cepstrum, the reference's own float32 error, which the limits
above hold. For LPC and LPCEPSTRA on the speech (condition number ~7e6 at
sharp formants) the reference's float32 LPC coefficients are ~10% of
their largest value away from a float64 evaluation, so end to end they
are held on the speech only at that conditioning (SPEECH_LPC_REL_*), in
full on an AR(2) noise signal, where the recursion is well-conditioned,
and stage by stage on the speech.

Also: the numpy table builders equal the reference's exactly; the golden
fixture at tests/test_golden_frontend.py's tolerances; batched ==
per-file exactly; the numbered errors 6320, 6321, 6322.
"""

import os

import numpy as np
import pytest
import torch

from htk_tpu.io import parmkind as pk
from htk_tpu.ops import dsp as jdsp
from htk_tpu_torch.ops import dsp as tdsp
from htk_tpu_torch.utils.errors import HTKError

from _frontend_stages import (STAGES, ar_noise as _ar_noise, frames_of,
                              port_stages, recursions_on, reference_stages,
                              rel, speech as _speech)
from _torch_compare import (FE_MAX, FE_MEAN, assert_scaled_close,  # noqa: F401
                            one_torch_thread)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "mfcc_golden.npz")


# LPC and LPCEPSTRA end to end on the speech, over the largest reference
# value: the reference's float32 recursion is itself ~10% (LPC) and ~30%
# (cepstra) of that away from float64 there (tests/_frontend_stages.py)
SPEECH_LPC_REL_MAX = 0.25
SPEECH_LPC_REL_MEAN = 5e-3
# the stages before the recursion, port float32 vs reference float32
STAGE_REL = 1e-6


@pytest.fixture(scope="module")
def speech():
    return _speech()


@pytest.fixture(scope="module")
def ar_noise():
    return _ar_noise()


def _both(wave, kind, **kw):
    k = pk.str2parmkind(kind)
    ref = jdsp.compute_features(wave, jdsp.FrontendConfig(target_kind=k, **kw))
    got = tdsp.compute_features(wave, tdsp.FrontendConfig(target_kind=k, **kw),
                                device="cpu")
    return got, ref


def _close(got, ref, scaled=False):
    assert got.shape == ref.shape and got.dtype == np.float32
    if scaled:
        assert_scaled_close(got, ref)
        return
    d = np.abs(got.astype(np.float64) - ref)
    assert d.max() <= FE_MAX, f"max |diff| {d.max()}"
    assert d.mean() <= FE_MEAN, f"mean |diff| {d.mean()}"


@pytest.mark.parametrize("kind,scaled", [
    ("MFCC_E_D_A", False), ("MFCC_0_D_A_Z", False), ("MFCC_E_D_A_Z", False),
    ("MFCC_E_N_D_A_T", False), ("MFCC_0_N_D", False), ("FBANK", False),
    ("FBANK_E_D_A", False), ("MELSPEC", True), ("MELSPEC_E", True),
    ("PLP_E_D_A", True), ("PLP_0", True), ("PLP_E_N_D_A_Z", True),
])
def test_kinds_on_speech(speech, kind, scaled):
    _close(*_both(speech, kind), scaled=scaled)


@pytest.mark.parametrize("kind,scaled", [
    ("LPC", False), ("LPC_E_D_A", False), ("LPC_0_N", False),
    ("LPCEPSTRA", True), ("LPCEPSTRA_E_D_A", True), ("LPCEPSTRA_0_Z", True),
])
def test_lpc_kinds_on_ar_noise(ar_noise, kind, scaled):
    _close(*_both(ar_noise, kind), scaled=scaled)


@pytest.mark.parametrize("kind", ["LPC", "LPC_E_D_A", "LPC_0_N", "LPCEPSTRA",
                                  "LPCEPSTRA_E_D_A", "LPCEPSTRA_0_Z"])
def test_lpc_kinds_on_speech(speech, kind):
    """End to end on the speech, at the limit its conditioning allows."""
    got, ref = _both(speech, kind)
    assert got.shape == ref.shape and got.dtype == np.float32
    s = float(np.abs(ref).max())
    d = np.abs(got.astype(np.float64) - ref) / s
    assert d.max() <= SPEECH_LPC_REL_MAX, (d.max(), s)
    assert d.mean() <= SPEECH_LPC_REL_MEAN, (d.mean(), s)


@pytest.mark.parametrize("kind", ["PLP", "LPCEPSTRA"])
def test_stages_on_speech(speech, kind):
    """On the same speech frames, the port's float32 stages before the
    recursion agree with the reference's to float32 rounding, and its
    Durbin and cepstrum recursions equal the reference's bit for bit on
    the reference's own float32 autocorrelation."""
    frames = frames_of(speech, kind)
    ref = reference_stages(frames, kind)
    got = port_stages(frames, kind, torch.float32)
    for k in STAGES[:STAGES.index("autoc") + 1]:
        if k in ref:
            assert rel(got[k], ref[k]) <= STAGE_REL, k
    port, want = recursions_on(ref["autoc"], kind)
    for g, w in zip(port, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind,kw", [
    ("MFCC_E_D_A", dict(enormalise=False)),
    ("MFCC_E_D_A", dict(zmean_source=True)),
    ("MFCC_E_D_A", dict(use_power=True)),
    ("MFCC_E_D_A", dict(add_dither=1.0)),
    ("MFCC_E_D_A", dict(warp_freq=1.1)),
    ("MFCC_E_D_A", dict(warp_freq=0.88, warp_lcut=300.0, warp_ucut=5000.0)),
    ("FBANK_E", dict(warp_freq=0.93, lo_freq=100.0, hi_freq=6000.0)),
    ("MFCC_E_D_A_T", dict(simple_diffs=True, delta_window=3,
                          acc_window=1)),
    ("MFCC_E_D", dict(raw_energy=False, escale=0.5, sil_floor=30.0)),
    ("MFCC_0", dict(use_hamming=False, preem_coef=0.0, cep_lifter=0,
                    num_chans=26, num_ceps=13)),
    ("MFCC_E_D_A", dict(samp_period=1250, num_chans=18)),
    ("PLP_E_D_A", dict(use_power=True, lpc_order=10, comp_factor=0.5)),
])
def test_options(speech, kind, kw):
    _close(*_both(speech, kind, **kw), scaled=kind.startswith("PLP"))


def test_dither_is_the_reference_draw(speech):
    """ADDDITHER draws from numpy's default_rng(12345), as the reference
    does: the dithered samples are bit for bit htk_tpu's."""
    cfg = tdsp.FrontendConfig(add_dither=2.0)
    rcfg = jdsp.FrontendConfig(add_dither=2.0)
    np.testing.assert_array_equal(tdsp._dithered(speech, cfg),
                                  jdsp._dithered(speech, rcfg))
    f1 = tdsp.compute_features(speech, cfg, device="cpu")
    np.testing.assert_array_equal(
        f1, tdsp.compute_features(speech, cfg, device="cpu"))
    assert not np.array_equal(
        f1, tdsp.compute_features(speech, tdsp.FrontendConfig(),
                                  device="cpu"))


@pytest.mark.parametrize("kw", [
    dict(), dict(num_chans=24, lo_freq=200.0, hi_freq=7000.0),
    dict(warp_freq=1.12, warp_lcut=250.0, warp_ucut=5500.0),
    dict(samp_period=1250, window_size=200000.0),
])
def test_tables_equal_reference(kw):
    t, r = tdsp.FrontendConfig(**kw), jdsp.FrontendConfig(**kw)
    np.testing.assert_array_equal(tdsp.mel_weight_matrix(t),
                                  jdsp.mel_weight_matrix(r))
    np.testing.assert_array_equal(tdsp.equal_loudness(t),
                                  jdsp.equal_loudness(r))
    np.testing.assert_array_equal(tdsp.dct_matrix(20, 12),
                                  jdsp.dct_matrix(20, 12))
    np.testing.assert_array_equal(tdsp.lifter_vector(12, 22),
                                  jdsp.lifter_vector(12, 22))
    np.testing.assert_array_equal(tdsp.plp_idft_matrix(20, 12),
                                  jdsp.plp_idft_matrix(20, 12))
    np.testing.assert_array_equal(tdsp.regression_matrix(9, 2, True),
                                  jdsp.regression_matrix(9, 2, True))
    assert (t.frame_size, t.frame_shift, t.fft_n, t.width()) == \
        (r.frame_size, r.frame_shift, r.fft_n, r.width())


def test_durbin_and_cepstra_on_identical_inputs():
    """The recursions themselves agree on the same float32 operands."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    sig = rng.normal(size=(40, 600))
    for i in range(1, 600):
        sig[:, i] += 0.6 * sig[:, i - 1]
    r = np.stack([np.sum(sig[:, : 600 - k] * sig[:, k:], axis=1)
                  for k in range(13)], axis=1).astype(np.float32)
    a_t, e_t = tdsp._durbin(torch.as_tensor(r), 12)
    a_j, e_j = jdsp._durbin(jnp.asarray(r), 12)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-5)
    c_t = tdsp._lpc_to_cepstra(a_t, 14)
    c_j = jdsp._lpc_to_cepstra(jnp.asarray(a_t.numpy()), 14, None)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kind,tol_max,tol_mean", [
    ("MFCC_E_D_A_Z", 2.0e-3, 3.0e-4),
    ("MFCC_0", 2.0e-3, 5.0e-4),
    ("FBANK", 3.0e-4, 1.0e-4),
    ("PLP", 2.0e-3, 2.0e-4),
])
def test_golden_fixture(kind, tol_max, tol_mean):
    """tests/test_golden_frontend.py's check, on the port."""
    z = np.load(GOLDEN)
    nch = 24 if kind == "FBANK" else 20
    got = tdsp.compute_features(
        z["waveform"].astype(np.float32),
        tdsp.FrontendConfig(target_kind=pk.str2parmkind(kind),
                            num_chans=nch), device="cpu")
    ref = z["feat_" + kind]
    assert got.shape == ref.shape
    d = np.abs(got - ref)
    assert d.max() < tol_max and d.mean() < tol_mean, (d.max(), d.mean())


def test_batch_equals_single_exactly_and_matches_reference():
    """compute_features_batch == compute_features per job, bit for bit,
    across lengths in different frame buckets, one landing exactly on a
    bucket with trailing samples, and two sample rates in one call; and
    within tolerance of htk_tpu's batched frontend."""
    rng = np.random.default_rng(5)
    kind = pk.str2parmkind("MFCC_E_D_A")
    jobs = [((rng.normal(size=n) * 2000).astype(np.float32), 625)
            for n in (4000, 4003, 5400, 17000, 66000)]
    jobs.append(((rng.normal(size=9000) * 2000).astype(np.float32), 1250))
    tj = [(s, tdsp.FrontendConfig(target_kind=kind, samp_period=p))
          for s, p in jobs]
    outs = tdsp.compute_features_batch(tj, device="cpu")
    refs = jdsp.compute_features_batch(
        [(s, jdsp.FrontendConfig(target_kind=kind, samp_period=p))
         for s, p in jobs])
    for (s, c), got, ref in zip(tj, outs, refs):
        np.testing.assert_array_equal(
            got, tdsp.compute_features(s, c, device="cpu"))
        _close(got, ref)
    # trailing samples past the last frame belong to no frame
    np.testing.assert_array_equal(
        outs[2], tdsp.compute_features(jobs[2][0][:5360], tj[2][1],
                                       device="cpu"))


def test_batch_independent_of_chunk_company():
    rng = np.random.default_rng(9)
    cfg = tdsp.FrontendConfig()
    a = (rng.normal(size=8000) * 3000).astype(np.float32)
    others = [(rng.normal(size=8100) * 3000).astype(np.float32)
              for _ in range(3)]
    alone = tdsp.compute_features_batch([(a, cfg)], device="cpu")[0]
    mixed = tdsp.compute_features_batch(
        [(o, cfg) for o in others] + [(a, cfg)], device="cpu")[-1]
    np.testing.assert_array_equal(alone, mixed)


@pytest.mark.parametrize("kind,n,code", [
    ("IREFC", 8000, 6320), ("MFCC_N_D", 8000, 6321), ("MFCC", 100, 6322),
])
def test_numbered_errors(kind, n, code):
    cfg = tdsp.FrontendConfig(target_kind=pk.str2parmkind(kind))
    x = np.ones(n, np.float32)
    with pytest.raises(HTKError) as e:
        tdsp.compute_features(x, cfg, device="cpu")
    assert e.value.code == code
    with pytest.raises(HTKError) as e:
        tdsp.compute_features_batch([(x, cfg)], device="cpu")
    assert e.value.code == code
