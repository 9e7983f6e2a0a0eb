"""Port time-sharded forward-backward (htk_tpu_torch parallel/timeshard.py)
against the port's serial scans and htk_tpu's, on the CPU.

The cases are tests/test_timeshard.py's: the 4-model chain of its small
set at T = 64, the 2-model chain at T = 32 (posteriors), and a batch of 4
utterances at T = 32 for the (dp x t) form. They run on gloo groups of
CPU processes (parallel/dryrun.spawn_ranks, one group a world size, all
cases of a size in one group): `fb_time_sharded` at D = 2 and 4 and
`fb_time_sharded_batch` on a (2, 2) mesh; each rank's blocks are
gathered whole. Each result is held against the port's serial
forward_scan/backward_scan/xi_scan and against
`htk_tpu.parallel.timeshard` on the conftest's virtual devices in a mesh
of the same shape, at tests/test_timeshard.py's tolerances (alphas and
betas where the serial value is above -1e9: atol 2e-3, rtol 1e-5; logP
abs 2e-3; xi atol 5e-3, rtol 5e-4); posteriors sum to 1 within 1e-4 on
its posteriors case and within the dry run's 1e-3 on the others; an
indivisible T (or B) raises ValueError. The block operator's parts
(band width, banded step, dense compose, identity) are held against the
reference's in this process, within 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from htk_tpu.algo.composite import build_composite
from htk_tpu.parallel import timeshard as jts
from htk_tpu_torch.algo.fb import backward_scan, forward_scan, xi_scan
from htk_tpu_torch.parallel import timeshard as ts
from htk_tpu_torch.parallel.dryrun import spawn_ranks
from htk_tpu_torch.utils.logmath import ladd_reduce

from _torch_compare import one_torch_thread  # noqa: F401
from _torch_ranks import SPAWN_TIMEOUT
from test_fb import small_set
from test_timeshard import _outp

TESTS = os.path.dirname(os.path.abspath(__file__))


def _hmm(seq):
    comp = small_set(nmix=2, dim=3, nstates=5)
    hmm = build_composite(comp, [comp.model_id(p) for p in seq])
    return [np.asarray(a, np.float32) for a in (hmm.logA, hmm.a0, hmm.aE)]


def _cases():
    """name -> (outp, logA, a0, aE): `one_` for fb_time_sharded, `two_`
    for fb_time_sharded_batch."""
    long4 = _hmm(("a", "b", "a", "b"))
    short = _hmm(("a", "b"))
    chain = build_composite(small_set(nmix=2, dim=3, nstates=5),
                            [0, 1, 0, 1])
    pair = build_composite(small_set(nmix=2, dim=3, nstates=5), [0, 1])
    return {
        "one_chain": (_outp(chain, 64), *long4),
        "one_pair": (_outp(pair, 32, seed=3), *short),
        "two_batch": (np.stack([_outp(chain, 32, seed=10 + b)
                                for b in range(4)]), *long4),
    }


def serial(outp, logA, a0, aE):
    """The port's serial scans of each utterance of outp (B, T, Q)."""
    B, T, Q = outp.shape
    o = torch.as_tensor(outp)
    A = torch.as_tensor(logA).expand(B, Q, Q)
    t_real = torch.full((B,), T, dtype=torch.int32)
    al = forward_scan(o, A, torch.as_tensor(a0).expand(B, Q), t_real)
    be = backward_scan(o, A, torch.as_tensor(aE).expand(B, Q), t_real)
    lp = ladd_reduce(al[:, 0] + be[:, 0], dim=-1)
    xi = xi_scan(al, be, o, A, lp, t_real)
    return [x.numpy() for x in (al, be, lp, xi)]


def reference(name, outp, logA, a0, aE, world):
    """htk_tpu's time-sharded FB on a mesh of the same shape."""
    devs = np.array(jax.devices()[:world])
    if name.startswith("one_"):
        got = jts.fb_time_sharded(outp, logA, a0, aE, Mesh(devs, ("t",)))
    else:
        got = jts.fb_time_sharded_batch(
            outp, logA, a0, aE,
            Mesh(devs.reshape(2, world // 2), ("d", "t")))
    return [np.asarray(x) for x in got]


def assert_fb_close(got, ref):
    """tests/test_timeshard.py's tolerances, per utterance."""
    al, be, lp, xi = [np.asarray(x).reshape((-1,) + np.shape(x)[-2:])
                      if np.ndim(x) >= 2 else np.atleast_1d(x) for x in got]
    al_r, be_r, lp_r, xi_r = [
        np.asarray(x).reshape((-1,) + np.shape(x)[-2:])
        if np.ndim(x) >= 2 else np.atleast_1d(x) for x in ref]
    for g, r in ((al, al_r), (be, be_r)):
        live = r > -1e9
        np.testing.assert_allclose(g[live], r[live], atol=2e-3, rtol=1e-5)
    np.testing.assert_allclose(lp, lp_r, atol=2e-3, rtol=0)
    np.testing.assert_allclose(xi, xi_r, atol=5e-3, rtol=5e-4)


@pytest.fixture(scope="module", params=[2, 4], ids=["D2", "D4"])
def sharded(request, tmp_path_factory):
    """(world, cases, {name: (alphas, betas, logP, xi)}) from one group
    of `world` ranks: every case at D = 2; at D = 4 every case, the batch
    on a (2, 2) mesh."""
    world = request.param
    cases = {k: v for k, v in _cases().items()
             if world == 4 or k.startswith("one_")}
    d = tmp_path_factory.mktemp(f"timeshard{world}")
    data, out = d / "cases.npz", d / "out.npz"
    np.savez(data, **{f"{k}:{a}": x for k, v in cases.items()
                      for a, x in zip(("outp", "logA", "a0", "aE"), v)})
    spawn_ranks(world, "_torch_ranks:timeshard_cases",
                {"data": str(data), "out": str(out)},
                timeout=SPAWN_TIMEOUT, path=[TESTS])
    z = np.load(out)
    res = {k: [z[f"{k}:{n}"] for n in ("alphas", "betas", "logp", "xi",
                                       "raised")] for k in cases}
    return world, cases, res


def test_matches_serial(sharded):
    _world, cases, res = sharded
    for name, ops in cases.items():
        outp = ops[0] if ops[0].ndim == 3 else ops[0][None]
        assert_fb_close(res[name][:4], serial(outp, *ops[1:]))


def test_matches_jax(sharded):
    world, cases, res = sharded
    for name, ops in cases.items():
        assert_fb_close(res[name][:4], reference(name, *ops, world))


def test_posteriors_normalise(sharded):
    """Within 1e-4 on tests/test_timeshard.py's posteriors case (the
    2-model chain at T = 32); within the dry run's 1e-3 on every case
    (the reference's own sums on the T = 64 chain part from 1 by 1.4e-4
    at D = 2)."""
    _world, _cases_, res = sharded
    for name, (al, be, lp, _xi, _r) in res.items():
        lp = np.reshape(lp, np.shape(lp) + (1, 1)[:al.ndim - 1])
        gamma = np.exp(al + be - lp)
        np.testing.assert_allclose(gamma.sum(axis=-1), 1.0,
                                   atol=1e-4 if name == "one_pair" else 1e-3,
                                   err_msg=name)


def test_indivisible_raises(sharded):
    _world, _cases_, res = sharded
    for name, r in res.items():
        assert r[4].all(), name


def test_indivisible_raises_before_any_collective():
    class OneAxis:
        def get_group(self, axis):
            return None

    ops = _cases()["one_chain"]
    # a world of 3 over a 64-frame utterance; nothing joins a group
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ts.dist, "get_world_size", lambda g=None: 3)
        mp.setattr(ts.dist, "get_rank", lambda g=None: 0)
        with pytest.raises(ValueError, match="T=64"):
            ts.fb_time_sharded(torch.as_tensor(ops[0]), *ops[1:], OneAxis())


@pytest.mark.parametrize("seq", [("a",), ("a", "b"), ("a", "b", "a", "b")])
def test_band_of_matches_jax(seq):
    logA = _hmm(seq)[0]
    assert ts._band_of(logA) == jts._band_of(logA)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_op_step_banded_matches_jax(lead):
    logA = _hmm(("a", "b", "a"))[0]
    Q = logA.shape[0]
    K = ts._band_of(logA)
    rng = np.random.default_rng(5)
    X = (-3.0 * rng.random(lead + (Q, Q))).astype(np.float32)
    X[..., rng.random((Q, Q)) < 0.3] = -1e10
    got = ts._op_step_banded(torch.as_tensor(X), torch.as_tensor(logA), K)
    ref = jts._op_step_banded(jnp.asarray(X), jnp.asarray(logA), K)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_op_compose_and_identity_match_jax():
    rng = np.random.default_rng(6)
    Q = 9
    X, Y = (-4.0 * rng.random((2, Q, Q))).astype(np.float32)
    Y[rng.random((Q, Q)) < 0.4] = -1e10
    got = ts._op_compose(torch.as_tensor(X), torch.as_tensor(Y))
    ref = jts._op_compose(jnp.asarray(X), jnp.asarray(Y))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(ts._identity_op(Q).numpy(),
                                  np.asarray(jts._identity_op(
                                      Q, jnp.float32)))
    # the identity is a unit of the product, batched or not
    Xb = torch.as_tensor(np.stack([X, X]))
    np.testing.assert_array_equal(
        ts._op_compose(ts._identity_op(Q).expand(2, Q, Q), Xb).numpy(),
        Xb.numpy())
