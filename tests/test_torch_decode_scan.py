"""Port decode recursion (htk_tpu_torch/ops/decode_scan.py) against htk_tpu.

The plain torch version is held against the JAX package's lax.scan
reference (vmapped `algo/decode.decode_scan`) and its Pallas kernel in
interpret mode, on the same random nets (numpy seeds). Tolerances are the
reference's own (tests/test_pallas_decode.py): live scores atol 1e-5,
word-link records exactly equal. The CUDA kernel is held against the
plain version in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from htk_tpu.algo.decode import decode_scan as jax_decode_scan
from htk_tpu.ops.decode_pallas import decode_scan_pallas, make_maskf
from htk_tpu_torch.ops import decode_scan as ds
from htk_tpu_torch.synth import random_decode_net
from htk_tpu_torch.utils.logmath import LZERO

from _torch_compare import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The port's tools run on the card unless the CPU is asked for."""
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


def run_plain(node_of_state, outp, band, a0, aE, bonus, trans, start, wpen,
              device="cpu"):
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    Nn = trans.shape[0]
    (v, wn, wt), (WE, pwn, pwt) = ds.decode_scan_plain(
        t(outp), t(band), t(a0), t(aE), t(node_of_state), t(bonus),
        t(trans), t(start), torch.full((Nn,), wpen, device=device), Nn)
    return [x.cpu().numpy() for x in (v, wn, wt, WE, pwn, pwt)]


def run_jax_scan(node_of_state, outp, band, a0, aE, bonus, trans, start,
                 wpen):
    Nn = int(trans.shape[0])
    (v, wn, wt), (WE, pwn, pwt) = jax.vmap(
        lambda o: jax_decode_scan(
            o, jnp.asarray(band), jnp.asarray(a0), jnp.asarray(aE),
            jnp.asarray(node_of_state), jnp.asarray(bonus),
            jnp.asarray(trans), jnp.asarray(start),
            jnp.full((Nn,), wpen, jnp.float32), Nn))(jnp.asarray(outp))
    return [np.asarray(x) for x in (v, wn, wt, WE, pwn, pwt)]


def run_jax_pallas(node_of_state, outp, band, a0, aE, bonus, trans, start,
                   wpen):
    Nn = int(trans.shape[0])
    (v, wn, wt), (WE, pwn, pwt) = decode_scan_pallas(
        jnp.asarray(outp), jnp.asarray(band), jnp.asarray(a0),
        jnp.asarray(aE), jnp.asarray(make_maskf(node_of_state, Nn)),
        jnp.asarray(bonus), jnp.asarray(trans), jnp.asarray(start),
        jnp.full((Nn,), wpen, jnp.float32), Nn, interpret=True)
    return [np.asarray(x) for x in (v, wn, wt, WE, pwn, pwt)]


def assert_same_decode(got, ref, atol=1e-5):
    """Live scores within atol, every word-link record exactly equal."""
    vg, wng, wtg, WEg, pwng, pwtg = got
    vr, wnr, wtr, WEr, pwnr, pwtr = ref
    live = vr > LZERO / 2
    np.testing.assert_array_equal(live, vg > LZERO / 2)
    np.testing.assert_allclose(vg[live], vr[live], atol=atol)
    np.testing.assert_array_equal(wng, wnr)
    np.testing.assert_array_equal(wtg, wtr)
    liveWE = WEr > LZERO / 2
    np.testing.assert_array_equal(liveWE, WEg > LZERO / 2)
    np.testing.assert_allclose(WEg[liveWE], WEr[liveWE], atol=atol)
    np.testing.assert_array_equal(pwng, pwnr)
    np.testing.assert_array_equal(pwtg, pwtr)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_jax_scan(seed):
    net = random_decode_net(seed)
    assert_same_decode(run_plain(*net, -1.0), run_jax_scan(*net, -1.0))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_interpret(seed):
    net = random_decode_net(seed, B=3, T=16)
    assert_same_decode(run_plain(*net, -1.0), run_jax_pallas(*net, -1.0))


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_tie_rules_match_jax_scan(seed):
    """Integer-valued scores: ties everywhere. The first maximising state
    (word ends), first source node (cross-word) and first band offset
    (within-word) pin the records, as in the reference."""
    net = random_decode_net(seed, Ns=40, Nn=6, K=3, B=2, T=24, ties=True)
    got = run_plain(*net, 0.0)
    ref = run_jax_scan(*net, 0.0)
    assert_same_decode(got, ref, atol=0.0)
    assert (got[4] >= 0).sum() > 10  # records really flow through ties


def test_first_state_rule_on_equal_word_ends():
    """Two member states end the word with the same score: the first
    one's record is taken, in the plain version and the reference."""
    # node 0 = states 0, 1 (1 reached from 0 inside the word); node 1 =
    # state 2. At t=1 state 0 re-enters across words (record (0, 0)) while
    # state 1 carries state 0's t=0 record (-1, -1), both scoring 0; both
    # sources tie in the cross-word step too.
    Ns, Nn, T = 3, 2, 3
    node_of_state = np.array([0, 0, 1], np.int32)
    outp = np.zeros((1, T, Ns), np.float32)
    band = np.array([[-1.0, -1.0, -1.0], [LZERO, 0.0, LZERO]], np.float32)
    a0 = np.array([0.0, LZERO, 0.0], np.float32)
    aE = np.zeros(Ns, np.float32)
    bonus = np.zeros(Ns, np.float32)
    trans = np.zeros((Nn, Nn), np.float32)
    start = np.zeros(Nn, np.float32)
    net = (node_of_state, outp, band, a0, aE, bonus, trans, start)
    got = run_plain(*net, 0.0)
    assert_same_decode(got, run_jax_scan(*net, 0.0), atol=0.0)
    WE, pwn, pwt = got[3], got[4], got[5]
    assert WE[0, 2, 0] == 0.0 and (pwn[0, 2, 0], pwt[0, 2, 0]) == (0, 0)
    # node 1 entered at t=1 from the first of two tied sources
    assert (pwn[0, 2, 1], pwt[0, 2, 1]) == (0, 0)
