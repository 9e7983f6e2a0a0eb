"""Port HFB (htk_tpu_torch algo/fb.py, ops/fb_scans.py,
algo/composite_device.py) against htk_tpu's, on the CPU.

Operands come from numpy seeds and the small sets of tests/test_fb.py and
tests/test_composite_device.py, and go through both packages:

  - the scans: the port's `fb_scans_plain` (batched) against the JAX
    package's Pallas kernel in interpret mode (no beam) and its
    `backward_scan`/`forward_scan`/`xi_scan` (with and without a beam),
    per utterance; alphas and betas at t < t_real within atol 1e-4, logP
    within 1e-6 relative, xi within rtol 1e-5, atol 1e-6;
  - the device assembler, tee chains included: int maps exactly equal,
    logA/a0/aE within atol 1e-6 (the tee-chain sums are cumulative sums,
    taken in another order);
  - the accumulators of a training pass, both trainers, at rtol 1e-5 (as
    tests/test_fb_pallas.py) plus 1e-5 of each field's scale: the scatter
    sums in another order than segment_sum, and OutP's and the moment
    sums' matmuls round differently;
  - the dead-cell argument the CUDA kernel rests on (csrc/fb_scans.cu):
    on banded, dense and all-dead composites, with and without a beam,
    `fb_scans_plain`'s outputs are bit-identical when every cell of logA
    at or below LZERO/2 takes other values in [2 LZERO, LZERO/2], and xi
    is exactly 0 on those cells.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htk_tpu.algo import fb as jfb
from htk_tpu.algo.composite import build_composite as j_build
from htk_tpu.algo.composite_device import make_assembler as j_assembler
from htk_tpu.algo.trainer import DeviceCompositeTrainer as JDeviceTrainer
from htk_tpu.algo.trainer import Trainer as JTrainer
from htk_tpu.algo.trainer import prepare_utterance as j_prep
from htk_tpu.algo.trainer import prepare_utterance_ids as j_prep_ids
from htk_tpu.ops.fb_pallas import fb_scans_pallas
from htk_tpu.utils.logmath import ladd_reduce as j_ladd_reduce
from htk_tpu_torch import convert
from htk_tpu_torch.algo.composite_device import make_assembler
from htk_tpu_torch.algo.trainer import (DeviceCompositeTrainer, Trainer,
                                        prepare_utterance,
                                        prepare_utterance_ids)
from htk_tpu_torch.ops import fb_scans as fbs
from htk_tpu_torch.synth import random_fb_operands
from htk_tpu_torch.utils.logmath import LZERO

from _torch_compare import one_torch_thread  # noqa: F401
from test_composite_device import tee_set
from test_fb import small_set


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


def scan_operands(seed, t_reals, T=23):
    """A batch of composites over models [0, 1, 0] of small_set, random
    outp (numpy), one row per t_real."""
    rng = np.random.default_rng(seed)
    hmm = j_build(small_set(nmix=2, seed=seed), [0, 1, 0])
    B, Q = len(t_reals), hmm.n_states
    outp = (rng.normal(size=(B, T, Q)) * 2 - 4).astype(np.float32)
    logA = np.broadcast_to(hmm.logA, (B, Q, Q)).copy()
    a0 = np.broadcast_to(hmm.a0, (B, Q)).copy()
    aE = np.broadcast_to(hmm.aE, (B, Q)).copy()
    return outp, logA, a0, aE, np.asarray(t_reals, np.int32)


def jax_scans(outp, logA, a0, aE, t_real, beam):
    """The JAX package's scans for one utterance, as numpy."""
    args = [jnp.asarray(x) for x in (outp, logA, a0, aE)]
    tr = jnp.asarray(t_real, jnp.int32)
    betas = jfb.backward_scan(args[0], args[1], args[3], tr, beam=beam)
    alphas = jfb.forward_scan(args[0], args[1], args[2], tr,
                              betas=betas if beam is not None else None)
    logp = j_ladd_reduce(alphas[max(int(t_real) - 1, 0)] + args[3], axis=0)
    xi = jfb.xi_scan(alphas, betas, args[0], args[1], logp, tr)
    return [np.asarray(x) for x in (alphas, betas, logp, xi)]


def assert_scans_close(got, ref, t_real):
    (al, be, lp, xi), (al_r, be_r, lp_r, xi_r) = got, ref
    np.testing.assert_allclose(al[:t_real], al_r[:t_real], rtol=0, atol=1e-4)
    np.testing.assert_allclose(be[:t_real], be_r[:t_real], rtol=0, atol=1e-4)
    assert float(lp) == pytest.approx(float(lp_r), rel=1e-6)
    np.testing.assert_allclose(xi, xi_r, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scans_plain_match_pallas_kernel(seed):
    ops = scan_operands(seed, [23, 12, 1, 0])
    got = [x.numpy() for x in fbs.fb_scans_plain(
        *[torch.as_tensor(x) for x in ops])]
    outp, logA, a0, aE, t_real = ops
    for b, tr in enumerate(t_real):
        ref = [np.asarray(x) for x in fb_scans_pallas(
            jnp.asarray(outp[b]), jnp.asarray(logA[b]), jnp.asarray(a0[b]),
            jnp.asarray(aE[b]), jnp.asarray(tr), interpret=True)]
        assert_scans_close([g[b] for g in got], ref, int(tr))


@pytest.mark.parametrize("seed,beam", [(0, None), (1, 1e6), (2, 3.0),
                                       (3, 8.0), (4, 0.5)])
def test_scans_plain_match_jax_scans(seed, beam):
    ops = scan_operands(seed, [23, 20, 7, 0])
    got = [x.numpy() for x in fbs.fb_scans_plain(
        *[torch.as_tensor(x) for x in ops], beam=beam)]
    outp, logA, a0, aE, t_real = ops
    for b, tr in enumerate(t_real):
        ref = jax_scans(outp[b], logA[b], a0[b], aE[b], tr, beam)
        assert_scans_close([g[b] for g in got], ref, int(tr))


def test_hopeless_beam_skips_the_utterance(capsys):
    """tests/test_fb.py's hopeless beam (5.0 on its fixture, no increment):
    logP is LZERO, the utterance adds nothing and is reported, in both
    packages."""
    jcomp = small_set(nmix=1)
    comp = convert.compiled_hmmset_from(jcomp)
    feats = np.random.default_rng(1).normal(size=(24, 3)).astype(np.float32)
    ref = JTrainer(jcomp, prune=(5.0, 0.0, 5.0)).accumulate(
        [j_prep(jcomp, "u0", feats, ["a", "b", "a"])], batch_size=2)
    capsys.readouterr()
    got = Trainer(comp, prune=(5.0, 0.0, 5.0), device="cpu").accumulate(
        [prepare_utterance(comp, "u0", feats, ["a", "b", "a"])],
        batch_size=2)
    err = capsys.readouterr().err
    assert "7323" in err and "7324" in err
    assert float(got.n_utts) == 0.0 and float(got.occ.sum()) == 0.0
    assert_accs_close(got, convert.accumulators_from(ref))


def test_dispatch_cpu_takes_plain():
    ops = [torch.as_tensor(x) for x in scan_operands(0, [23, 5])]
    before = fbs.KERNEL.launches
    got = fbs.fb_scans(*ops, beam=4.0)
    assert fbs.KERNEL.launches == before
    for g, r in zip(got, fbs.fb_scans_plain(*ops, beam=4.0)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("seq,kpad,tees", [
    (["a", "b", "a", "b", "b"], 8, False),
    (["a"], 4, False),
    (["a", "sp", "b"], 6, True),
    (["a", "sp", "sp", "b"], 6, True),
    (["sp", "a", "b", "sp"], 6, True),
])
def test_assembler_matches_jax(seq, kpad, tees):
    jcomp = tee_set() if tees else small_set(nmix=2, seed=1)
    comp = convert.compiled_hmmset_from(jcomp)
    ids = np.full((2, kpad), -1, np.int32)
    ids[0, :len(seq)] = [jcomp.model_id(n) for n in seq]
    ids[1, :2] = [jcomp.model_id(n) for n in seq[-2:][::-1]] if len(
        seq) > 1 else [0, 0]
    ref = {k: np.asarray(v) for k, v in
           jax.jit(j_assembler(jcomp))(jnp.asarray(ids)).items()}
    got = {k: v.numpy() for k, v in
           make_assembler(comp, device="cpu")(torch.as_tensor(ids)).items()}
    assert set(got) == set(ref)
    for k in ("comp_state", "q_mask", "tr_seg", "entry_seg", "exit_seg"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("logA", "a0", "aE"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("entry", ["make_assembler", "zero_accs"])
def test_library_entries_take_no_default_device(entry):
    """The library entry points run where the caller says: `device` is a
    required keyword, positional or missing it is refused."""
    from htk_tpu_torch.algo.fb import zero_accs

    comp = convert.compiled_hmmset_from(small_set(nmix=2, seed=1))
    call = {"make_assembler": lambda *a, **k: make_assembler(comp, *a, **k),
            "zero_accs": lambda *a, **k: zero_accs(2, 3, 4, 2, 5, *a, **k)
            }[entry]
    for args in ((), ("cpu",)):
        with pytest.raises(TypeError):
            call(*args)
    assert call(device="cpu") is not None


def _utts(jcomp, n=5, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        T = int(rng.integers(12, 40))
        feats = rng.normal(size=(T, 3)).astype(np.float32)
        out.append((f"u{i}", feats, [["a", "b"], ["b", "a", "b"]][i % 2]))
    return out


def assert_accs_close(got, ref):
    """Each field within rtol 1e-5, plus an atol of 1e-5 of the field's
    largest magnitude: XLA's and torch's float32 matmuls (OutP, the moment
    sums) and scatters add in other orders, so a cell whose terms cancel
    to near zero keeps the rounding of its largest terms."""
    assert float(got.total_logp) == pytest.approx(float(ref.total_logp),
                                                  rel=1e-6)
    for f in ("total_frames", "n_utts"):
        assert float(getattr(got, f)) == float(getattr(ref, f))
    for f in ("occ", "wt_occ", "sum_x", "sum_xx", "tr"):
        r = getattr(ref, f).numpy()
        np.testing.assert_allclose(getattr(got, f).numpy(), r, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(r).max()),
                                   err_msg=f)


@pytest.mark.parametrize("device_composite", [True, False])
@pytest.mark.parametrize("nmix", [1, 2])
def test_fb_batch_accumulators_match_jax(device_composite, nmix):
    jcomp = small_set(nmix=nmix, seed=3)
    comp = convert.compiled_hmmset_from(jcomp)
    data = _utts(jcomp)
    if device_composite:
        ref = JDeviceTrainer(jcomp).accumulate(
            [j_prep_ids(jcomp, *u) for u in data], batch_size=4)
        got = DeviceCompositeTrainer(comp, device="cpu").accumulate(
            [prepare_utterance_ids(comp, *u) for u in data], batch_size=4)
    else:
        ref = JTrainer(jcomp).accumulate(
            [j_prep(jcomp, *u) for u in data], batch_size=4)
        got = Trainer(comp, device="cpu").accumulate(
            [prepare_utterance(comp, *u) for u in data], batch_size=4)
    assert_accs_close(got, convert.accumulators_from(ref))


def test_retry_ladder_matches_jax(capsys):
    """-t 5 5 20: the utterance fails at beam 5 (tests/test_fb.py's
    fixture) and passes on the retry at 10, in both packages."""
    jcomp = small_set(nmix=1)
    comp = convert.compiled_hmmset_from(jcomp)
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(24, 3)).astype(np.float32)
    ref = JTrainer(jcomp, prune=(5.0, 5.0, 20.0)).accumulate(
        [j_prep(jcomp, "u0", feats, ["a", "b", "a"])], batch_size=2)
    capsys.readouterr()
    got = Trainer(comp, prune=(5.0, 5.0, 20.0), device="cpu").accumulate(
        [prepare_utterance(comp, "u0", feats, ["a", "b", "a"])],
        batch_size=2, trace=1)
    assert "retrying 1 utterance(s) at beam 10.0" in capsys.readouterr().out
    assert float(got.n_utts) == 1.0
    assert_accs_close(got, convert.accumulators_from(ref))


def composite(kind, seed):
    """fb_scans operands (numpy) whose logA is banded (random_fb_operands:
    a band, random long links, 4 padded states), dense among the live
    states, or all dead; rows with t_real < T and t_real = 0."""
    ops = list(random_fb_operands(seed, B=4, T=30, Q=40,
                                  t_real=[30, 21, 9, 0]))
    if kind == "dense":
        rng = np.random.default_rng(seed + 50)
        ops[1][:, :36, :36] = np.log(rng.uniform(0.05, 1.0, (4, 36, 36)))
    elif kind == "all_dead":
        ops[1][:] = LZERO
    return ops


@pytest.mark.parametrize("kind", ["banded", "dense", "all_dead"])
@pytest.mark.parametrize("beam", [None, 10.0, 3.0])
def test_dead_cells_change_nothing(kind, beam):
    """Every cell of logA at or below LZERO/2 replaced by other values in
    [2 LZERO, LZERO/2] (uniform draws, and the interval's lower end):
    alphas, betas, logP and xi bit-identical; xi exactly 0 on those
    cells. The kernel leaves such cells out of its sums."""
    ops = composite(kind, seed=3)
    ref = fbs.fb_scans_plain(*[torch.as_tensor(x) for x in ops], beam=beam)
    dead = ops[1] <= LZERO / 2
    rng = np.random.default_rng(11)
    for fill in (rng.uniform(2 * LZERO, LZERO / 2, ops[1].shape),
                 np.full(ops[1].shape, 2 * LZERO)):
        logA = np.where(dead, fill, ops[1]).astype(np.float32)
        assert bool((logA[dead] <= LZERO / 2).all())
        got = fbs.fb_scans_plain(
            *[torch.as_tensor(x) for x in (ops[0], logA, *ops[2:])],
            beam=beam)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    xi = ref[3].numpy()
    assert (xi[dead] == 0).all()
    if kind == "all_dead":
        assert (ref[2].numpy() == np.float32(LZERO)).all()
    else:
        assert (ref[2].numpy()[:3] > LZERO / 2).all() and (xi != 0).any()
