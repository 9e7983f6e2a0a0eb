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
from htk_tpu_torch.ops._cuda import SMEM_MAX
from htk_tpu_torch.synth import random_fb_operands, random_sparse_fb_operands
from htk_tpu_torch.utils.logmath import LSMALL, LZERO, MINLOGEXP, ladd_reduce

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


# The two designs of the fb_scans kernel (csrc/fb_scans.cu): which shapes
# take which, and the wide design's split of the states over warps and its
# per-warp reduction, modelled here in numpy/torch (the kernel computes the
# split on the card from the list offsets; split_point mirrors it).

def split_point(off, NW, k, state_cost=fbs.STATE_COST):
    """csrc/fb_scans.cu split_point: the least q in [0, Q] with (off[q] +
    state_cost q) NW >= k (off[Q] + state_cost Q)."""
    Q = len(off) - 1
    cost = (off.astype(np.int64) + state_cost * np.arange(Q + 1)) * NW
    return int(np.searchsorted(cost, k * (int(off[Q]) + state_cost * Q),
                               side="left"))


def wide_lists(logA):
    """The wide tables' lists of one utterance (numpy), as the kernel
    writes them: direction 0 the successors of each row, direction 1 the
    predecessors of each column, ascending, with their offsets."""
    live = logA > LZERO / 2
    out = []
    for m in (live, live.T):
        off = np.concatenate([[0], np.cumsum(m.sum(axis=1))])
        q, nb = np.nonzero(m)  # row-major: ascending within each row
        out.append((off, nb))
    return out


def phone_loop_logA(n_models, lp=-2.0):
    """A 3-state-per-model phone loop's logA (numpy), make_phone_loop's
    shape: within-model self-loops and next links, every exit to every
    entry."""
    Q = 3 * n_models
    A = np.full((Q, Q), LZERO, np.float32)
    q = np.arange(Q)
    A[q, q] = np.log(0.6)
    nxt = q[q % 3 != 2]
    A[nxt, nxt + 1] = np.log(0.4)
    A[np.ix_(q[2::3], q[0::3])] = np.log(0.4) + lp
    return A


def sparse_logA(seed, Q):
    outp, (b, i, j, v), _a0, _aE, _tr = random_sparse_fb_operands(
        seed, B=1, T=2, Q=Q, hubs=3)
    A = np.full((Q, Q), LZERO, np.float32)
    A[i, j] = v
    return A


@pytest.mark.parametrize("B,T,Q,beam,design", [
    (8, 512, 192, None, "narrow"),  # HERest's FB batch
    (8, 512, 192, 10.0, "narrow"),  # HERest -t
    (256, 32, 16, None, "narrow"),  # HMMIRest's arc buckets
    (4096, 32, 16, None, "narrow"),  # HMMIRest's widest padded launch
    (1, 504, 256, None, "narrow"),  # mix_posteriors_utterance, FULLC, -K
    (8, 512, 895, None, "narrow"),  # below the measured crossover
    (1, 256, 895, 10.0, "narrow"),
    (8, 512, 896, None, "wide"),
    (1, 256, 1024, None, "wide"),
    (1, 504, 10332, None, "wide"),  # the phone loop (config #4)
    (1, 64, 19360, None, "wide"),  # past the narrow design's smem
    (3, 64, 20480, 10.0, "wide"),
])
def test_fb_plan_picks_the_design(B, T, Q, beam, design):
    assert fbs.fb_plan(B, T, Q, beam) == design


def test_fb_plan_refuses_nothing_and_sends_every_q_past_smem_wide():
    """Every Q whose narrow state vectors do not fit shared memory goes
    to the wide design, with and without a beam; no Q is refused."""
    for beam in (None, 5.0):
        dirs = 2 if beam is not None else 1
        for Q in list(range(1, 40000, 97)) + [10 ** 5, 10 ** 6]:
            plan = fbs.fb_plan(1, 100, Q, beam)
            assert plan in ("narrow", "wide")
            if fbs.smem_bytes(Q, dirs, 0) > SMEM_MAX:
                assert plan == "wide"
            if plan == "narrow":
                fbs.scan_smem(Q, beam is not None)  # fits: no refusal


@pytest.mark.parametrize("kind", ["sparse", "phone_loop"])
@pytest.mark.parametrize("NW", [1, 7, 32, 66 * 32, 5000])
def test_wide_split_covers_every_live_cell_once(kind, NW):
    """Each warp of NW owns states [split(k), split(k + 1)); over both
    directions' lists every live cell of logA is visited exactly once, in
    its list's ascending order, and each state by one warp; states of
    LONG_LIST entries or more are whole warps' work."""
    logA = sparse_logA(4, 700) if kind == "sparse" else phone_loop_logA(150)
    Q = logA.shape[0]
    live = logA > LZERO / 2
    for d, (off, nb) in enumerate(wide_lists(logA)):
        bounds = [split_point(off, NW, k) for k in range(NW + 1)]
        assert bounds[0] == 0 and bounds[-1] == Q
        assert all(a <= b for a, b in zip(bounds, bounds[1:]))
        seen = np.zeros((Q, Q), np.int64)
        n_long = 0
        for k in range(NW):
            for q in range(bounds[k], bounds[k + 1]):
                cells = nb[off[q]:off[q + 1]]
                assert (np.diff(cells) > 0).all()
                n_long += len(cells) >= fbs.LONG_LIST
                if d == 0:
                    seen[q, cells] += 1
                else:
                    seen[cells, q] += 1
        assert (seen == live).all()
        if kind == "phone_loop":  # every exit (d 0) or entry (d 1) is long
            assert n_long == 150
    # shares: no warp holds more than its share plus one state's cost
    off = wide_lists(logA)[1][0]
    cost = off + fbs.STATE_COST * np.arange(Q + 1)
    bounds = [split_point(off, NW, k) for k in range(NW + 1)]
    share = cost[-1] / NW
    worst = max(cost[b] - cost[a] for a, b in zip(bounds, bounds[1:]))
    assert worst <= share + np.diff(cost).max()


def warp_ladd_model(x):
    """csrc/fb_scans.cu warp_ladd on the terms x (float32, list order):
    lane l takes x[l], x[l + 32], ...; the max; each lane's sum of
    exp(x - max) over its terms not below minLogExp, last term first (the
    second pass walks backwards); then the xor-shuffle sum (offsets 16,
    8, 4, 2, 1)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    hi = x.max()
    if hi < LSMALL:
        return torch.tensor(LZERO)
    n = len(x)
    pad = torch.full((-(-n // 32) * 32,), float("-inf"))
    pad[:n] = x - hi
    terms = torch.where(pad < MINLOGEXP, torch.zeros(()), torch.exp(pad))
    lanes = torch.zeros(32)
    for r in terms.reshape(-1, 32).flip(0):  # each lane's, last first
        lanes = lanes + r
    for s in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[torch.arange(32) ^ s]
    return hi + torch.log(lanes[0])


@pytest.mark.parametrize("n", [64, 65, 100, 3444, 20480])
@pytest.mark.parametrize("seed", [0, 1])
def test_wide_warp_ladd_equals_ladd_reduce(n, seed):
    """The long-list reduction (max over the lanes, then each lane's sum
    of the terms not below minLogExp, then a shuffle sum) equals
    ladd_reduce within 1e-6 relative: the same terms, another order;
    also where most terms fall below minLogExp of the max."""
    rng = np.random.default_rng(seed)
    for scale in (1.0, 30.0):
        x = (rng.normal(size=n) * scale - 500.0).astype(np.float32)
        got = float(warp_ladd_model(x))
        ref = float(ladd_reduce(torch.as_tensor(x)))
        assert got == pytest.approx(ref, rel=1e-6)
    assert float(warp_ladd_model(np.full(n, LZERO, np.float32))) == LZERO


@pytest.mark.parametrize("beam", [None, 10.0, 3.0])
def test_xi_false_leaves_the_scans_unchanged(beam):
    """xi=False: alphas, betas and logP bit-equal to the full call's, xi
    None (the tuple keeps its arity), through fb_scans_plain and the
    dispatcher alike."""
    ops = [torch.as_tensor(x) for x in composite("banded", seed=5)]
    full = fbs.fb_scans_plain(*ops, beam=beam)
    for fn in (fbs.fb_scans_plain, fbs.fb_scans):
        got = fn(*ops, beam=beam, xi=False)
        assert len(got) == 4 and got[3] is None
        for g, r in zip(got[:3], full[:3]):
            assert torch.equal(g, r)
