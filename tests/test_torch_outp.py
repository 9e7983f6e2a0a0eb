"""Port OutP (htk_tpu_torch/ops/outp.py) against htk_tpu/ops/outp.py.

The same Gaussians, states and frames (numpy seed) go through both
packages' `all_state_outp`, on a diagonal set and a FULLC set.

Tolerance: atol 1e-3 on state log-likelihoods (a few hundred in size).
The diagonal scorer expands (x - mu)^2 / var into x^2 a - 2 x b + c, which
cancels in f32, and the two libraries sum the 2D products and the mixture
terms in different orders; differences of a few 1e-4 are rounding, not
algorithm.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from htk_tpu.ops import outp as jax_outp
from htk_tpu_torch.ops import outp as torch_outp
from htk_tpu_torch.utils.logmath import LZERO

from _torch_compare import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The port's tools run on the card unless the CPU is asked for."""
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")

ATOL = 1e-3


def random_set(seed, M=24, S=7, n_slots=4, D=39):
    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(M, D)) * 2).astype(np.float32)
    variances = (0.5 + rng.random((M, D))).astype(np.float32)
    gconsts = (D * np.log(2 * np.pi)
               + np.log(variances.astype(np.float64)).sum(1)).astype(np.float32)
    state_mix = rng.integers(0, M, (S, n_slots)).astype(np.int32)
    state_mix[1, 2:] = -1  # padded slots
    state_mix[4, 1:] = -1
    w = rng.random((S, n_slots)) + 0.1
    w = np.where(state_mix >= 0, w, 0.0)
    w /= w.sum(1, keepdims=True)
    state_logw = np.where(state_mix >= 0, np.log(np.maximum(w, 1e-30)),
                          LZERO).astype(np.float32)
    x = (rng.normal(size=(50, D)) * 2).astype(np.float32)
    return x, means, variances, gconsts, state_mix, state_logw


def random_fullc(seed, M=10, D=6):
    """Precision Cholesky factors embedded as the JAX package compiles
    FULLC sets: fc_proj = L with P = L L^T, fc_mu = mu @ L."""
    rng = np.random.default_rng(seed)
    fc_proj = np.zeros((M, D, D), np.float32)
    fc_mu = np.zeros((M, D), np.float32)
    gconsts = np.zeros(M, np.float32)
    mus = rng.normal(size=(M, D))
    for m in range(M):
        A = rng.normal(size=(D, D))
        P = A @ A.T + np.eye(D)
        L = np.linalg.cholesky(P)
        fc_proj[m] = L
        fc_mu[m] = mus[m] @ L
        gconsts[m] = D * np.log(2 * np.pi) - np.linalg.slogdet(P)[1]
    return fc_proj, fc_mu, gconsts, mus.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_diag_all_state_outp_matches_jax(seed):
    x, means, variances, gconsts, state_mix, state_logw = random_set(seed)
    ref, ref_m = jax_outp.all_state_outp(
        jnp.asarray(x), jnp.asarray(means), jnp.asarray(variances),
        jnp.asarray(gconsts), jnp.asarray(state_mix),
        jnp.asarray(state_logw), precision="highest")
    t = torch.as_tensor
    got, got_m = torch_outp.all_state_outp(
        t(x), t(means), t(variances), t(gconsts),
        t(state_mix.astype(np.int64)), t(state_logw), precision="highest")
    np.testing.assert_allclose(got_m.numpy(), np.asarray(ref_m), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_fullc_all_state_outp_matches_jax():
    fc_proj, fc_mu, gconsts, mus = random_fullc(0)
    M, D = fc_mu.shape
    rng = np.random.default_rng(5)
    x = rng.normal(size=(20, D)).astype(np.float32)
    state_mix = np.array([[0, 1, 2], [3, -1, -1], [4, 5, 9], [6, 7, 8]],
                         np.int32)
    state_logw = np.where(state_mix >= 0, np.log(1 / 3), LZERO).astype(
        np.float32)
    ref, _ = jax_outp.all_state_outp(
        jnp.asarray(x), None, None, jnp.asarray(gconsts),
        jnp.asarray(state_mix), jnp.asarray(state_logw),
        precision="highest", fc_proj=jnp.asarray(fc_proj),
        fc_mu=jnp.asarray(fc_mu))
    t = torch.as_tensor
    got, got_m = torch_outp.all_state_outp(
        t(x), None, None, t(gconsts), t(state_mix.astype(np.int64)),
        t(state_logw), precision="highest", fc_proj=t(fc_proj),
        fc_mu=t(fc_mu))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    # and against the f64 Mahalanobis form
    P = np.einsum("mde,mfe->mdf", fc_proj.astype(np.float64),
                  fc_proj.astype(np.float64))
    dx = x[:, None, :].astype(np.float64) - mus[None]
    q = np.einsum("tmd,mde,tme->tm", dx, P, dx)
    np.testing.assert_allclose(got_m.numpy(), -0.5 * (gconsts[None] + q),
                               atol=ATOL)


def test_gaussian_scorer_equals_functional_form():
    """The module's packed buffers give all_state_outp's state scores."""
    from htk_tpu_torch.models.hmmset import CompiledHMMSet

    x, means, variances, gconsts, state_mix, state_logw = random_set(2)
    S = state_mix.shape[0]
    comp = CompiledHMMSet(
        means=means, variances=variances, gconsts=gconsts,
        state_mix=state_mix, state_logw=state_logw,
        log_transp=np.zeros((1, 3, 3), np.float32),
        model_nstates=np.zeros(1, np.int32),
        model_states=np.zeros((1, 1), np.int32),
        model_transp=np.zeros(1, np.int32), slot_blocks=[(0, 4)],
        state_sw=np.ones((S, 4), np.float32))
    sc = torch_outp.GaussianScorer(comp, "cpu")
    t = torch.as_tensor
    ref, _ = torch_outp.all_state_outp(
        t(x), t(means), t(variances), t(gconsts),
        t(state_mix.astype(np.int64)), t(state_logw),
        slot_blocks=[(0, 4)], state_sw=t(comp.state_sw))
    got = sc(t(x)[None])[0]
    assert torch.equal(got, ref)
    assert sc.Wt.shape == (2 * means.shape[1], means.shape[0])


def test_matmul_precision_sets_and_restores_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    with torch_outp.matmul_precision("high"):
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    with torch_outp.matmul_precision("highest"):
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == old


def test_ladd_twins_match_jax():
    from htk_tpu.utils import logmath as jl
    from htk_tpu_torch.utils import logmath as tl

    rng = np.random.default_rng(3)
    a = (rng.normal(size=(6, 9)) * 30).astype(np.float32)
    a[0, :4] = LZERO
    a[1, :] = LZERO
    a[2, 1] = a[2, 0] + tl.MINLOGEXP - 1.0  # below minLogExp: dropped
    b = np.roll(a, 1, axis=1)
    np.testing.assert_allclose(
        tl.ladd(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(jl.ladd(a, b)), rtol=1e-6)
    np.testing.assert_allclose(
        tl.ladd_reduce(torch.as_tensor(a), dim=1).numpy(),
        np.asarray(jl.ladd_reduce(a, axis=1)), rtol=1e-6)
    assert (tl.LZERO, tl.LSMALL, tl.MINLOGEXP) == (jl.LZERO, jl.LSMALL,
                                                  jl.MINLOGEXP)
