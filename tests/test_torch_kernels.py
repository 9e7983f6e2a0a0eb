"""The port's kernel wrappers (htk_tpu_torch/ops/decode_scan.py,
ops/fb_scans.py, ops/maxplus.py, ops/tropical.py and ops/xw_gather.py with
its callers ops/xw_route.py and ops/xw_window.py).

No JAX here, so the `cuda`-marked tests also run on a machine with a card
and no JAX (`--noconftest`; see README). On the CPU: the dispatchers take
the plain versions for CPU tensors and count no launch, the wrappers
refuse what the kernels cannot take, and the decode kernel's partition
(node ranges, shared-memory budget) and its once-per-tensor plan
hold. On the card: the decode kernel equals its plain version (live
scores within 1e-5, word-link records exactly), on random nets and with
tie-heavy integer scores, at forced grids of 1, 2, 3 and 7 blocks and the
full grid, B up to 40, in chunks of utterances with its columns in shared
memory and (3,000 nodes over 2 blocks) in global memory, and HVite on the
card writes the same rec.mlf as on the CPU; the FB scans kernel agrees
with its plain version (logP within 1e-5 relative; alphas and betas at
t < t_real with the same live sets and within 1e-5 |ref| + 1e-4; xi of
live utterances within rtol 1e-4, atol 1e-6; xi exactly 0 on dead
cells), with and without a beam, on banded and dense composites at
Q = 50, 192, 250 and 1,100, with the live-cell lists in shared and in
global memory, and in a 4,096-wide launch of one real row (HMMIRest's
padding at t_real = 0); its wide design (forced by path=) the same, at
B = 1 and 3, on banded, dense and sparse composites with hub lists of
about Q / 2 (a warp each) up to Q = 20,480, where the narrow design
refuses and the dispatcher takes the wide one; xi=False on both designs
leaves alphas, betas and logP bit-equal; and HERest on the card trains
the same model as on the
CPU; the maxplus kernel equals its plain version exactly (values and
first-max arguments, both floor contracts, ties and dead rows), at
forced chunk counts of the source range too, through ops/maxplus and the
tropical wrappers, and the LV decoder on the card gives the CPU's words
and times; segmax's skip flag leaves the outputs unwritten; the segmax
and gather-add kernels equal their plain versions
exactly (values and first-slot arguments; empty, single, long segments,
ties, dead rows, -inf cells; segmax at every forced lane count with WE's
rows in shared memory and read from L2, on views at an odd element
offset at C = 701, and at C = 60,000, whose rows do not fit in shared
memory; gather-add at N % 4 in {0, 1, 2, 3} and on views at an
odd element offset), through the routed, window and probe wrappers too,
operands off the card are refused, and the factored LV decoder on the
card gives the CPU's words and times with one segmax launch a padded
frame. The CPU-side tests of the maxplus wrappers are in
tests/test_torch_maxplus.py, of the xw wrappers in tests/test_torch_xw.py.
"""

import numpy as np
import pytest
import torch

from htk_tpu_torch.ops import decode_scan as ds
from htk_tpu_torch.ops import fb_scans as fbs
from htk_tpu_torch.ops import maxplus as mp
from htk_tpu_torch.ops import tropical as trop
from htk_tpu_torch.ops import xw_gather as xg
from htk_tpu_torch.ops._cuda import SMEM_MAX
from htk_tpu_torch.synth import (random_decode_net, random_fb_operands,
                                 random_maxplus_operands,
                                 random_sparse_fb_operands,
                                 random_xw_operands)
from htk_tpu_torch.utils.errors import HTKError
from htk_tpu_torch.utils.logmath import LZERO

from _torch_compare import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The port's tools run on the card unless the CPU is asked for."""
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


def operands(net, device="cpu", wpen=-1.0):
    """decode_scan's argument list from random_decode_net's arrays."""
    nos, outp, band, a0, aE, bonus, trans, start = [
        torch.as_tensor(a, device=device) for a in net]
    Nn = trans.shape[0]
    return [outp, band, a0, aE, nos, bonus, trans, start,
            torch.full((Nn,), wpen, device=device), Nn]


def assert_same(got, ref, atol=1e-5):
    (v, wn, wt), (WE, pwn, pwt) = got
    (vr, wnr, wtr), (WEr, pwnr, pwtr) = ref
    for a, b in ((v, vr), (WE, WEr)):
        live = b > LZERO / 2
        assert torch.equal(live, a > LZERO / 2)
        assert torch.allclose(a[live], b[live], atol=atol, rtol=0)
    for a, b in ((wn, wnr), (wt, wtr), (pwn, pwnr), (pwt, pwtr)):
        assert torch.equal(a, b)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def test_dispatch_cpu_takes_plain_and_counts_no_launch():
    args = operands(random_decode_net(0, B=1, T=5))
    before = ds.KERNEL.launches
    out = ds.decode_scan(*args)
    assert ds.KERNEL.launches == before
    assert_same(out, ds.decode_scan_plain(*args), atol=0.0)


def test_operand_checks_raise():
    args = operands(random_decode_net(0, B=1, T=5))
    bad = list(args)
    bad[6] = args[6][:4]  # trans not (Nn, Nn)
    with pytest.raises(ValueError):
        ds.decode_scan(*bad)
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(TypeError):
        ds.decode_scan(*bad)
    bad = list(args)
    bad[1] = args[1].t().contiguous().t()  # band not contiguous
    with pytest.raises(ValueError):
        ds.decode_scan(*bad)
    with pytest.raises(ValueError):  # no implementation on this device
        ds.decode_scan(*[a.to("meta") if torch.is_tensor(a) else a
                         for a in args])


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        ds.decode_scan_cuda(*operands(random_decode_net(0, B=1, T=5)))


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
def test_kernel_matches_plain_on_card(ties):
    need_card()
    for seed in range(3):
        args = operands(random_decode_net(seed, Ns=600, Nn=40, K=3, B=3,
                                          T=40, ties=ties), "cuda")
        before = ds.KERNEL.launches
        got = ds.decode_scan(*args)
        assert ds.KERNEL.launches == before + 1
        ref = ds.decode_scan_plain(*args)
        torch.cuda.synchronize()
        assert_same(got, ref)


def partition_of(net, K, G):
    nos = net[0]
    node_off = np.searchsorted(nos, np.arange(net[6].shape[0] + 1))
    return node_off, ds.partition(node_off, K, G)


@pytest.mark.parametrize("seed,G", [(0, 1), (1, 2), (2, 3), (3, 7),
                                    (4, 132), (5, 300)])
@pytest.mark.parametrize("wide", [False, True])
def test_partition_covers_states_at_node_boundaries(seed, G, wide):
    """Every state in exactly one range, ranges on node boundaries (empty
    ones where Nn < G or a node is wider than an even share), a block's
    columns are its nodes, and the shared-memory flag and chunk follow the
    budget."""
    K = 3
    net = random_decode_net(seed, Ns=900, Nn=60, K=K, B=1, T=2)
    if wide:  # one node holds half the states
        nos = net[0].copy()
        nos[100:550] = nos[100]
        net = (np.sort(nos),) + net[1:]
    node_off, part = partition_of(net, K, G)
    nodes, states = part.nodes, part.states
    assert len(nodes) == G + 1 and nodes[0] == 0 and nodes[-1] == 60
    assert (np.diff(nodes) >= 0).all()
    np.testing.assert_array_equal(states, node_off[nodes])
    owner = np.repeat(np.arange(G), np.diff(states))
    assert len(owner) == 900  # each state in exactly one range
    np.testing.assert_array_equal(
        net[0], np.repeat(np.arange(60), np.diff(node_off)))
    for g in range(G):  # a block's states are its nodes' states
        s0, s1 = states[g], states[g + 1]
        assert set(net[0][s0:s1]) <= set(range(nodes[g], nodes[g + 1]))
    assert part.cols_max == max(1, int(np.diff(nodes).max()))
    if G > 60:
        assert (np.diff(nodes) == 0).any()
    assert part.nnp % 4 == 0 and (part.nnp // 4) % 2 == 1 and (
        60 <= part.nnp < 68)
    budget = ds.smem_bytes(part.nnp, part.cols_max, part.jw, 1, True)
    assert part.trans_in_smem == (budget <= SMEM_MAX)
    b = part.bchunk_max
    assert ds.smem_bytes(part.nnp, part.cols_max, part.jw, b,
                         part.trans_in_smem) <= SMEM_MAX < ds.smem_bytes(
        part.nnp, part.cols_max, part.jw, b + 1, part.trans_in_smem)
    assert part.jw in (1, 2, 4, 8, 16, 32) and (
        part.jw >= min(part.cols_max, 32))
    assert part.gw == 16  # 15 states a node on average


def test_partition_balances_and_flags_global_columns():
    """Config-4's shape on the full H100 grid keeps its ~8 columns in
    shared memory; 3,000 nodes over 2 blocks read theirs from L2; a net
    whose WE row cannot fit is refused with HError 8528."""
    off = np.searchsorted(np.sort(np.random.default_rng(0).integers(
        0, 1000, 11955)), np.arange(1001))
    part = ds.partition(off, 2, 132)
    assert part.trans_in_smem and part.cols_max <= 10 and part.bchunk_max >= 8
    work = np.diff(np.concatenate([[0], np.cumsum(
        1000 + 10 * np.diff(off))])[part.nodes])
    assert work.max() < 1.5 * work.mean()
    part = ds.partition(np.arange(3001) * 3, 3, 2)
    assert not part.trans_in_smem and part.cols_max == 1500
    with pytest.raises(HTKError) as e:
        ds.partition(np.arange(60001), 2, 132)
    assert e.value.code == 8528


def test_plan_validates_once_per_node_of_state_tensor():
    """The node_of_state checks, node offsets and partition are built once
    per tensor and (Nn, K, G), and again after an in-place change."""
    net = random_decode_net(0, Ns=300, Nn=20, K=3, B=1, T=2)
    nos = torch.as_tensor(net[0])
    p1 = ds._plan(nos, 20, 3, 7)
    assert ds._plan(nos, 20, 3, 7) is p1
    assert ds._plan(nos, 20, 3, 5) is not p1
    np.testing.assert_array_equal(p1["node_off"].numpy(),
                                  np.searchsorted(net[0], np.arange(21)))
    nos.flip(0).contiguous()  # a copy: the cache stays
    assert ds._plan(nos, 20, 3, 7) is p1
    nos[0] = 19  # in place: rebuilt, and refused
    with pytest.raises(HTKError) as e:
        ds._plan(nos, 20, 3, 7)
    assert e.value.code == 8528


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 3, 7, None])
@pytest.mark.parametrize("B", [1, 8, 17, 40])
def test_kernel_matches_plain_at_forced_grids_on_card(G, B):
    """Range edges and halos fall inside the K-band; None is the full
    grid (more blocks than nodes)."""
    need_card()
    for seed, ties in ((B, True), (B + 1, False)):
        args = operands(random_decode_net(seed, Ns=600, Nn=40, K=3, B=B,
                                          T=24, ties=ties), "cuda")
        got = ds.decode_scan_cuda(*args, grid=G)
        ref = ds.decode_scan_plain(*args)
        torch.cuda.synchronize()
        assert_same(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("Ns,Nn,G,B,in_smem", [(6000, 3000, 2, 7, False),
                                              (3000, 600, 7, 9, True)])
def test_kernel_takes_utterances_in_chunks_on_card(Ns, Nn, G, B, in_smem):
    """More utterances than a block's shared memory holds at once, with
    the columns read from L2 (3,000 nodes over 2 blocks: 1,500 columns a
    block) and kept in shared memory."""
    need_card()
    net = random_decode_net(0, Ns=Ns, Nn=Nn, K=3, B=B, T=10, ties=True)
    _off, part = partition_of(net, 3, G)
    assert part.trans_in_smem == in_smem and part.bchunk_max < B
    args = operands(net, "cuda", wpen=0.0)
    got = ds.decode_scan_cuda(*args, grid=G)
    ref = ds.decode_scan_plain(*args)
    torch.cuda.synchronize()
    assert_same(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 3, None])
@pytest.mark.parametrize("cuts", [[1], [23], [8, 9, 16], list(range(1, 24))])
def test_kernel_carry_matches_plain_on_card(G, cuts):
    """A run cut into chunks, the state carried from each to the next
    (`init`, `t0`): the kernel's records and finals equal the plain
    version's over the same chunks and one unsplit launch's, bit for
    bit."""
    need_card()
    for seed, ties in ((len(cuts), True), (len(cuts) + 1, False)):
        args = operands(random_decode_net(seed, Ns=600, Nn=40, K=3, B=3,
                                          T=24, ties=ties), "cuda")
        runs = []
        for launch in (lambda *a, **k: ds.decode_scan_cuda(*a, grid=G, **k),
                       ds.decode_scan_plain):
            carry, recs = None, []
            for a, b in zip([0] + cuts, cuts + [24]):
                carry, r = launch(args[0][:, a:b].contiguous(), *args[1:],
                                  init=carry, t0=a)
                recs.append(r)
            runs.append(list(carry) + [torch.cat(p, 1) for p in zip(*recs)])
        whole = ds.decode_scan_cuda(*args, grid=G)
        torch.cuda.synchronize()
        for x, y, z in zip(runs[0], runs[1], list(whole[0]) + list(whole[1])):
            assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.cuda
def test_kernel_refuses_unsorted_nodes_on_card():
    need_card()
    args = operands(random_decode_net(0, B=1, T=5), "cuda")
    args[4] = args[4].flip(0).contiguous()
    with pytest.raises(HTKError) as e:
        ds.decode_scan_cuda(*args)
    assert e.value.code == 8528


@pytest.mark.cuda
@pytest.mark.parametrize("single", [False, True])
def test_hvite_on_card_equals_cpu(tmp_path, monkeypatch, single):
    """Batched buckets (-S) and the per-utterance path (one file)."""
    need_card()
    from htk_tpu_torch.synth import write_system
    from htk_tpu_torch.tools import hvite

    s = write_system(str(tmp_path), n_words=12, n_phones=8, n_tied=30,
                     n_mix=2, n_utts=5, min_frames=60, max_frames=150,
                     fanout=4, seed=3)
    files = [s.dict, s.hmmlist, s.feats[1]] if single else [
        "-S", s.scp, s.dict, s.hmmlist]
    out = {}
    for dev in ("cuda", "cpu"):
        monkeypatch.setattr(hvite, "default_device",
                            lambda d=dev: torch.device(d))
        mlf = str(tmp_path / f"{dev}.mlf")
        before = ds.KERNEL.launches
        assert hvite.run(["-w", s.wdnet, "-H", s.hmmdefs, "-i", mlf]
                         + files) == 0
        assert (ds.KERNEL.launches > before) == (dev == "cuda")
        with open(mlf, "rb") as f:
            out[dev] = f.read()
    assert out["cuda"] == out["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("floor", [False, True])
@pytest.mark.parametrize("mode", [{}, {"ties": True}, {"dead_rows": 2}])
def test_maxplus_kernel_matches_plain_on_card(floor, mode):
    """Exactly equal values and first-max arguments, any (B, C)."""
    need_card()
    for seed, (B, C) in enumerate([(1, 1), (3, 130), (8, 1000), (17, 257)]):
        WE, tr = [torch.as_tensor(a, device="cuda") for a in
                  random_maxplus_operands(seed, B=B, C=C, **mode)]
        before = mp.KERNEL.launches
        got = mp.maxplus(WE, tr, floor)
        assert mp.KERNEL.launches == before + 1
        ref = mp.maxplus_plain(WE, tr, floor)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
def test_tropical_wrappers_match_plain_on_card():
    need_card()
    WE, tr = [torch.as_tensor(a, device="cuda") for a in
              random_maxplus_operands(4, B=5, C=300, ties=True)]
    tT = trop.pad_tropical_operand(tr)
    WEp = torch.full((8, tT.shape[0]), LZERO, device="cuda")
    WEp[:5, :300] = WE
    before = (trop.LAUNCHES.launches, mp.KERNEL.launches)
    got = trop.tropical_matvec_argmax_padded(WEp, tT)
    one = trop.tropical_matvec_argmax(WE, tr)
    assert (trop.LAUNCHES.launches, mp.KERNEL.launches) == (before[0] + 2,
                                                            before[1])
    ref = mp.maxplus_plain(WE, tr, floor=True)
    torch.cuda.synchronize()
    for out in (one, tuple(x[:5, :300] for x in got)):
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 2, 3, 7, None])
def test_maxplus_kernel_at_forced_chunks_on_card(chunks):
    """The source range split into 1, 2, 3 and 7 chunks and the full grid
    (None): exactly the plain version, values and first-max arguments,
    for B in {1, 8, 17} and C in {1, 200, 1000, 2050}, tie-heavy and with
    dead rows, both floor contracts."""
    need_card()
    for B in (1, 8, 17):
        for C in (1, 200, 1000, 2050):
            for mode in ({"ties": True}, {"dead_rows": 1}):
                WE, tr = [torch.as_tensor(a, device="cuda") for a in
                          random_maxplus_operands(B + C, B=B, C=C, **mode)]
                for floor in (False, True):
                    got = mp.maxplus_cuda(WE, tr, floor, chunks=chunks)
                    ref = mp.maxplus_plain(WE, tr, floor)
                    torch.cuda.synchronize()
                    assert torch.equal(got[0], ref[0]), (B, C, mode, floor)
                    assert torch.equal(got[1], ref[1]), (B, C, mode, floor)


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("B", [1, 8])
def test_segmax_skip_flag_on_card(B, staged):
    """segmax_cuda(skip=...): a false flag gives the plain result; a true
    one leaves every output as allocated (no block writes); both launch
    once, with WE's rows in shared memory and read from L2."""
    need_card()
    ops = [torch.as_tensor(a, device="cuda") for a in random_xw_operands(
        0, B=B, C=700, n_slots=30000, ties=True, dead_rows=B // 8)]
    C_out = 705  # more columns than segments: outputs start filled
    ref = xg.segmax_plain(*ops, C_out)
    for flag in (False, True):
        skip = torch.tensor(flag, device="cuda")
        before = xg.SEGMAX.launches
        got = xg.segmax_cuda(*ops, C_out, skip=skip, staged=staged)
        assert xg.SEGMAX.launches == before + 1
        torch.cuda.synchronize()
        if flag:
            assert bool((got[0] == 2 * LZERO).all())
            assert bool((got[1] == -1).all())
        else:
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def inf_cells(ops, every=37):
    """random_xw_operands' WE with -inf in every `every`-th column."""
    ops[0][:, ::every] = -np.inf
    return ops


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [None, True, False])
@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32, None])
def test_segmax_kernel_at_forced_lanes_and_staging_on_card(lanes, staged):
    """Every segment on G lanes (1-32, or the schedule's own per width),
    WE's rows in shared memory, read from L2, or as the launch chooses:
    exactly the plain version, values and first-slot arguments, for B in
    {1, 8, 17} (one, one and three row groups when staged), tie-heavy and
    normal scores, dead rows, -inf cells, segments of 0, 1, 4-64 and
    500-700 slots."""
    need_card()
    for B in (1, 8, 17):
        for ties in (False, True):
            ops = [torch.as_tensor(a, device="cuda") for a in inf_cells(
                random_xw_operands(B + 3 * ties, B=B, C=700, n_slots=30000,
                                   ties=ties, dead_rows=min(B - 1, 2)))]
            got = xg.segmax_cuda(*ops, 705, lanes=lanes, staged=staged)
            ref = xg.segmax_plain(*ops, 705)
            torch.cuda.synchronize()
            assert torch.equal(got[0], ref[0]), (B, ties)
            assert torch.equal(got[1], ref[1]), (B, ties)


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("B", [1, 8])
def test_segmax_kernel_scalar_edges_on_card(B, staged):
    """WE, preds and scores as views at an odd element offset (no 16-byte
    loads of the slot stream, nor of WE's rows into shared memory) and
    C = 701 (rows not a multiple of 4 floats): exactly the plain
    version."""
    need_card()
    ops = inf_cells(random_xw_operands(B, B=B, C=701, n_slots=30000,
                                       ties=True, dead_rows=B // 8))
    ops = [odd_view(a, "cuda") for a in ops[:3]] + [
        torch.as_tensor(a, device="cuda") for a in ops[3:]]
    for lanes in (1, 4, None):
        got = xg.segmax_cuda(*ops, 701, lanes=lanes, staged=staged)
        ref = xg.segmax_plain(*ops, 701)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [4, None])
@pytest.mark.parametrize("B", [1, 8, 17])
def test_segmax_kernel_rows_beyond_shared_memory_on_card(B, lanes):
    """C = 60,000: one row of WE (240 KB) does not fit in shared memory, so
    the kernel gathers through L2 (and refuses a forced copy); exactly the
    plain version."""
    need_card()
    rng = np.random.default_rng(B)
    ops = list(inf_cells(random_xw_operands(B, B=B, C=700, n_slots=30000,
                                            ties=True, dead_rows=B // 8)))
    C = 60000
    ops[0] = inf_cells([np.where(rng.random((B, C)) < 0.2, 2 * LZERO,
                                 -rng.integers(0, 3, (B, C)))
                        .astype(np.float32)])[0]
    ops[1] = rng.integers(0, C, ops[1].shape[0]).astype(np.int32)
    ops = [torch.as_tensor(a, device="cuda") for a in ops]
    got = xg.segmax_cuda(*ops, 700, lanes=lanes)
    ref = xg.segmax_plain(*ops, 700)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    with pytest.raises(ValueError):
        xg.segmax_cuda(*ops, 700, lanes=lanes, staged=True)


@pytest.mark.cuda
def test_lv_decode_on_card_equals_cpu(tmp_path):
    """decode_batch on a uniform-row net (write_system's lm.arpa): the
    same words and times as on the CPU, scores within 1e-5 relative, one
    maxplus launch per padded frame."""
    need_card()
    from htk_tpu_torch.algo.decode import decode_batch
    from htk_tpu_torch.algo.lvnet import compile_lv_loop
    from htk_tpu_torch.algo.net import word_internal_phone_map
    from htk_tpu_torch.io.dictionary import read_dict
    from htk_tpu_torch.io.htkfeat import read_htk_file
    from htk_tpu_torch.io.lm import read_arpa
    from htk_tpu_torch.io.mmf import load_mmf
    from htk_tpu_torch.models.hmmset import compile_hmmset
    from htk_tpu_torch.synth import write_system

    s = write_system(str(tmp_path), n_words=30, n_phones=8, n_tied=30,
                     n_mix=2, n_utts=4, min_frames=60, max_frames=150,
                     fanout=4, seed=3)
    comp = compile_hmmset(load_mmf([s.hmmdefs]))
    vocab = read_dict(s.dict)
    net = compile_lv_loop(list(vocab.words), vocab, comp,
                          lm=read_arpa(s.lm),
                          phone_map=word_internal_phone_map(comp.names))
    feats = [read_htk_file(p).data for p in s.feats]
    before = mp.KERNEL.launches
    on_card = decode_batch(net, comp, feats, 8.0, -10.0, device="cuda")
    T = -(-max(f.shape[0] for f in feats) // 128) * 128
    assert mp.KERNEL.launches - before == T
    on_cpu = decode_batch(net, comp, feats, 8.0, -10.0, device="cpu")
    for g, r in zip(on_card, on_cpu):
        assert (g.words, g.times) == (r.words, r.times)
        assert g.score == pytest.approx(r.score, rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 17])
@pytest.mark.parametrize("ties", [False, True])
def test_xw_kernels_match_plain_on_card(B, ties):
    need_card()
    for seed in range(2):
        ops = [torch.as_tensor(a, device="cuda") for a in random_xw_operands(
            seed, B=B, C=700, n_slots=30000, ties=ties,
            dead_rows=1 if B > 1 else 0)]
        before = (xg.SEGMAX.launches, xg.GATHER_ADD.launches)
        got = xg.segmax(*ops, 700)
        g2 = xg.gather_add(*ops[:3])
        assert (xg.SEGMAX.launches, xg.GATHER_ADD.launches) == (
            before[0] + 1, before[1] + 1)
        ref = xg.segmax_plain(*ops, 700)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert torch.equal(g2, xg.gather_add_plain(*ops[:3]))


def on(a, device):
    return torch.as_tensor(a, device=device)


def odd_view(a, device):
    """`a` as a contiguous view one element into a larger buffer, so that
    its data pointer is not 16-byte aligned."""
    t = torch.as_tensor(a, device=device)
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 17])
@pytest.mark.parametrize("tail", [0, 1, 2, 3])
def test_gather_add_kernel_edges_on_card(B, tail):
    """N % 4 in {0, 1, 2, 3} (misaligned output rows at B > 1), lp given
    and None, operands at an odd element offset: exactly the plain
    version, one launch a call; lane_gather on such views too."""
    need_card()
    rng = np.random.default_rng(B * 4 + tail)
    C, N = 300, 4 * 257 + tail
    WE = rng.normal(size=(B, C)).astype(np.float32)
    pred = rng.integers(0, C, N).astype(np.int32)
    lp = rng.normal(size=N).astype(np.float32)
    for view in (on, odd_view):
        W, P, L = (view(a, "cuda") for a in (WE, pred, lp))
        for lpt in (L, None):
            before = xg.GATHER_ADD.launches
            got = xg.gather_add(W, P, lpt)
            assert xg.GATHER_ADD.launches == before + 1
            torch.cuda.synchronize()
            assert torch.equal(got, xg.gather_add_plain(W, P, lpt))
        idx = view(pred[:N - N % 4].reshape(-1, 4), "cuda")
        assert torch.equal(xg.lane_gather(W, idx), W[0][idx.long()])


@pytest.mark.cuda
def test_xw_wrappers_refuse_operands_off_the_card():
    need_card()
    ops = [torch.as_tensor(a, device="cuda")
           for a in random_xw_operands(0, B=2, C=40, n_slots=400)]
    with pytest.raises(ValueError):
        xg.gather_add(ops[0], ops[1].cpu(), ops[2])
    with pytest.raises(ValueError):
        xg.segmax(ops[0], ops[1], ops[2].cpu(), ops[3], ops[4], 40)
    with pytest.raises(ValueError):
        xg.lane_gather(ops[0], ops[1][:40].reshape(4, 10).cpu())
    with pytest.raises(ValueError):  # a table with no row to gather from
        xg.lane_gather(ops[0][:0], ops[1][:40].reshape(4, 10))


@pytest.mark.cuda
def test_xw_wrappers_match_cpu_on_card():
    """routed_explicit_leg, window_gather, bucket_max and lane_gather on the
    card equal the same calls on the CPU (the plain versions)."""
    need_card()
    import numpy as np

    from htk_tpu_torch.ops import xw_route, xw_window

    rng = np.random.default_rng(0)
    C, N = 3000, 40000
    src, tgt = rng.integers(0, C, N), rng.integers(0, C, N)
    p = rng.normal(size=N).astype(np.float32)
    WE = rng.normal(size=(8, C)).astype(np.float32)
    plan = xw_route.build_route(src, tgt, p, C)
    tabs = xw_window.window_tables(src, p)[:3]
    out = {}
    for dev in ("cuda", "cpu"):
        W = torch.as_tensor(WE, device=dev)
        out[dev] = [
            *xw_route.routed_explicit_leg(
                W, xw_route.device_tables(plan, dev)),
            xw_window.window_gather(W, *[torch.as_tensor(a, device=dev)
                                         for a in tabs]),
            xg.bucket_max(W[0], *[torch.as_tensor(a, device=dev) for a in (
                src[:N // 16 * 16].reshape(-1, 16).astype(np.int32),
                p[:N // 16 * 16].reshape(-1, 16))]),
            xg.lane_gather(W, torch.as_tensor(
                src[:128 * 64].reshape(64, 128).astype(np.int32),
                device=dev))]
    for g, r in zip(out["cuda"], out["cpu"]):
        assert torch.equal(g.cpu(), r)


@pytest.mark.cuda
def test_factored_lv_decode_on_card_equals_cpu():
    """decode_batch on a factored net (synth.lv_system), exact and
    adaptive: the CPU's words and times, scores within 1e-5 relative, one
    segmax launch per padded frame."""
    need_card()
    from htk_tpu_torch.algo.decode import decode_batch
    from htk_tpu_torch.algo.lvnet import compile_lv_loop
    from htk_tpu_torch.synth import lv_system

    sysm = lv_system(60, n_tied=40, n_mix=2, n_utts=4, min_frames=60,
                     max_frames=150, seed=3)
    net = compile_lv_loop(sysm.words, sysm.vocab, sysm.comp, lm=sysm.lm,
                          factored=True)
    T = -(-max(f.shape[0] for f in sysm.feats) // 128) * 128
    for ma in (None, -8):
        before = xg.SEGMAX.launches
        on_card = decode_batch(net, sysm.comp, sysm.feats, 12.0,
                               max_active=ma, device="cuda")
        assert xg.SEGMAX.launches - before == T
        on_cpu = decode_batch(net, sysm.comp, sysm.feats, 12.0,
                              max_active=ma, device="cpu")
        for g, r in zip(on_card, on_cpu):
            assert (g.words, g.times) == (r.words, r.times)
            assert g.score == pytest.approx(r.score, rel=1e-5)


def fb_operands(seed=0, device="cpu", **kw):
    return [torch.as_tensor(a, device=device)
            for a in random_fb_operands(seed, **kw)]


def assert_scans_agree(got, ref, t_real):
    """Kernel against plain at the tolerances in the module docstring."""
    al, be, lp, xi = got
    al_r, be_r, lp_r, xi_r = ref
    assert torch.allclose(lp, lp_r, rtol=1e-5, atol=0)
    for b, tr in enumerate(t_real.tolist()):
        for g, r in ((al[b, :tr], al_r[b, :tr]), (be[b, :tr], be_r[b, :tr])):
            live = r > LZERO / 2
            assert torch.equal(live, g > LZERO / 2)
            d = (g[live] - r[live]).abs()
            assert bool((d <= 1e-5 * r[live].abs() + 1e-4).all())
        if float(lp_r[b]) > LZERO / 2:  # a failed utterance's xi is unused
            assert torch.allclose(xi[b], xi_r[b], rtol=1e-4, atol=1e-6)


def test_fb_dispatch_cpu_takes_plain_and_counts_no_launch():
    args = fb_operands(0, B=2, T=12, Q=20, t_real=[12, 7])
    before = fbs.KERNEL.launches
    out = fbs.fb_scans(*args, beam=5.0)
    assert fbs.KERNEL.launches == before
    for g, r in zip(out, fbs.fb_scans_plain(*args, beam=5.0)):
        assert torch.equal(g, r)


def test_fb_operand_checks_raise():
    args = fb_operands(0, B=2, T=12, Q=20)
    bad = list(args)
    bad[1] = args[1][:, :5]  # logA not (B, Q, Q)
    with pytest.raises(ValueError):
        fbs.fb_scans(*bad)
    bad = list(args)
    bad[4] = args[4].long()
    with pytest.raises(TypeError):
        fbs.fb_scans(*bad)
    bad = list(args)
    bad[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        fbs.fb_scans(*bad)
    with pytest.raises(ValueError):
        fbs.fb_scans(*[a.to("meta") for a in args])
    with pytest.raises(ValueError):
        fbs.fb_scans_cuda(*args)


def dense_fb_operands(seed=0, device="cpu", **kw):
    """random_fb_operands with every cell among the live states live (an
    ergodic composite): each state's list is the whole live range."""
    ops = random_fb_operands(seed, **kw)
    dead = kw.get("dead", 4)
    Q = ops[0].shape[2]
    rng = np.random.default_rng(seed + 100)
    live = Q - dead
    ops[1][:, :live, :live] = np.log(rng.uniform(
        0.05, 1.0, (ops[1].shape[0], live, live))).astype(np.float32)
    return [torch.as_tensor(a, device=device) for a in ops]


FB_LAYOUTS = {"banded": fb_operands, "dense": dense_fb_operands}


@pytest.mark.parametrize("Q,layout,in_smem", [
    (50, "banded", True), (192, "banded", True), (250, "banded", True),
    (50, "dense", True), (192, "dense", False), (1100, "banded", False),
    (1100, "dense", False)])
def test_fb_list_layouts_cover_shared_and_global(Q, layout, in_smem):
    """The card tests' operands put the live-cell lists in shared memory
    (banded composites up to Q = 250, and the dense one at Q = 50) and in
    global memory (dense at Q = 192 and above; at Q = 1,100 the banded
    composite's 2% random long links alone are ~24,000 cells), with a
    beam and without."""
    logA = FB_LAYOUTS[layout](0, B=4, T=3, Q=Q)[1]
    for beam in (False, True):
        assert fbs.lists_in_smem(logA, beam) == in_smem


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [50, 192, 250, 1100])
@pytest.mark.parametrize("beam", [None, 10.0, 5.0, 2.0])
@pytest.mark.parametrize("layout", ["banded", "dense"])
def test_fb_kernel_matches_plain_on_card(Q, beam, layout):
    """Banded composites and dense ones, their lists in shared and in
    global memory (test_fb_list_layouts_cover_shared_and_global); no beam
    runs the two scans in separate blocks;
    beam 5 kills some rows and beam 2 all of them on the banded
    operands; rows with t_real < T and t_real = 0. Through the
    dispatcher (fb_plan's design: wide at Q = 1,100) and on the narrow
    design forced by path=."""
    need_card()
    for seed in range(2):
        args = FB_LAYOUTS[layout](seed, "cuda", B=4, T=40, Q=Q,
                                  t_real=[40, 33, 20, 0])
        before = fbs.KERNEL.launches
        got = fbs.fb_scans(*args, beam=beam)
        assert fbs.KERNEL.launches == before + 1
        narrow = fbs.fb_scans_cuda(*args, beam=beam, path="narrow")
        ref = fbs.fb_scans_plain(*args, beam=beam)
        torch.cuda.synchronize()
        dead = args[1] <= LZERO / 2
        for out in (got, narrow):
            assert_scans_agree(out, ref, args[4])
            assert bool((out[3][dead] == 0).all())


@pytest.mark.cuda
def test_fb_kernel_wide_padded_launch_on_card():
    """HMMIRest's arc launches pad with composite 0 at t_real = 0: one
    real row in a launch 4,096 wide, the rest copies of its operands that
    must stay inert (no read at t_real - 1 = -1; logP from alpha_0, as
    the plain version's)."""
    need_card()
    outp, logA, a0, aE, _tr = random_fb_operands(3, B=1, T=32, Q=16)
    args = [torch.as_tensor(np.repeat(a, 4096, axis=0), device="cuda")
            .contiguous() for a in (outp, logA, a0, aE)]
    t_real = torch.zeros(4096, dtype=torch.int32, device="cuda")
    t_real[0] = 18
    got = fbs.fb_scans(*args, t_real)
    ref = fbs.fb_scans_plain(*args, t_real)
    torch.cuda.synchronize()
    assert_scans_agree(got, ref, t_real)
    assert torch.equal(got[2][1:], got[2][1:2].expand(4095))


def wide_operands(seed, B, Q, T=40, device="cuda"):
    """fb_scans operands of a large composite: random_sparse_fb_operands'
    live cells (self-loops, next links, random links and hub rows and
    columns of about Q / 2 cells) laid into a dense logA on `device`; rows
    with t_real = T, T - 7 and 0."""
    outp, (b, i, j, v), a0, aE, tr = random_sparse_fb_operands(
        seed, B=B, T=T, Q=Q, t_real=[T, T - 7, 0][:B])
    logA = torch.full((B, Q, Q), LZERO, device=device)
    logA[torch.as_tensor(b, device=device), torch.as_tensor(i, device=device),
         torch.as_tensor(j, device=device)] = torch.as_tensor(v, device=device)
    return [torch.as_tensor(outp, device=device), logA,
            *(torch.as_tensor(a, device=device) for a in (a0, aE, tr))]


def test_fb_wide_operands_have_long_and_short_lists():
    """The wide card tests' operands give the wide design both kinds of
    list in both directions: the hubs' (a warp each) and the rest (a
    lane each)."""
    logA = wide_operands(0, 1, 700, T=3, device="cpu")[1][0]
    live = logA > LZERO / 2
    for counts in (live.sum(dim=1), live.sum(dim=0)):
        assert int((counts >= fbs.LONG_LIST).sum()) >= 3
        assert int((counts < fbs.LONG_LIST).sum()) >= 600


WIDE_CASES = [(Q, layout, beam) for Q, layout in (
    (50, "banded"), (250, "dense"), (700, "sparse"), (3000, "sparse"),
    (20480, "sparse")) for beam in (None, 10.0, 2.0)
    if Q < 20480 or beam != 2.0]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("Q,layout,beam", WIDE_CASES)
def test_fb_wide_design_matches_plain_on_card(B, Q, layout, beam):
    """The wide design forced by path=, against the plain version: small
    banded and dense composites (a state or a few a warp), sparse ones
    with hub lists of about Q / 2 (a warp each), up to Q = 20,480, past
    the narrow design's limit; beams that keep, thin and kill rows (2.0
    kills all the banded rows); rows with t_real < T and t_real = 0."""
    need_card()
    if layout == "sparse":
        args = wide_operands(0, B, Q)
    else:
        args = FB_LAYOUTS[layout](0, "cuda", B=B, T=40, Q=Q,
                                  t_real=[40, 33, 0][:B])
    before = fbs.KERNEL.launches
    got = fbs.fb_scans_cuda(*args, beam=beam, path="wide")
    assert fbs.KERNEL.launches == before + 1
    torch.cuda.synchronize()
    ref = fbs.fb_scans_plain(*args, beam=beam)
    torch.cuda.synchronize()
    assert_scans_agree(got, ref, args[4])
    assert bool((got[3][args[1] <= LZERO / 2] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("Q,beam", [(700, None), (700, 10.0), (3000, None)])
def test_fb_wide_design_reads_the_state_vector_from_l2_on_card(
        monkeypatch, B, Q, beam):
    """The wide scan's variant for Q past 57,856, whose state vector does
    not fit a block's shared memory and is read from L2: forced at a
    small Q by a shared-memory allowance of 0 bytes, against the plain
    version."""
    need_card()
    monkeypatch.setattr(fbs, "WIDE_VEC_SMEM", 0)
    assert fbs.wide_vec_smem(Q) == 0
    args = wide_operands(2, B, Q)
    got = fbs.fb_scans_cuda(*args, beam=beam, path="wide")
    ref = fbs.fb_scans_plain(*args, beam=beam)
    torch.cuda.synchronize()
    assert_scans_agree(got, ref, args[4])


@pytest.mark.cuda
def test_fb_dispatch_takes_the_wide_design_past_the_narrow_limit():
    """fb_scans on a composite of 20,480 states (the narrow design
    refuses Q past 19,359) launches the kernel once and agrees with the
    plain version."""
    need_card()
    args = wide_operands(1, 1, 20480, T=24)
    assert fbs.fb_plan(1, 24, 20480, None) == "wide"
    with pytest.raises(ValueError, match="do not fit"):
        fbs.fb_scans_cuda(*args, path="narrow")
    before = fbs.KERNEL.launches
    got = fbs.fb_scans(*args)
    assert fbs.KERNEL.launches == before + 1
    ref = fbs.fb_scans_plain(*args)
    torch.cuda.synchronize()
    assert_scans_agree(got, ref, args[4])


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["narrow", "wide"])
@pytest.mark.parametrize("beam", [None, 5.0])
def test_fb_xi_false_on_card(path, beam):
    """xi=False on either design: xi None, alphas, betas and logP
    bit-equal to the same design's full launch; one launch counted."""
    need_card()
    args = fb_operands(2, "cuda", B=3, T=40, Q=250, t_real=[40, 21, 0])
    full = fbs.fb_scans_cuda(*args, beam=beam, path=path)
    before = fbs.KERNEL.launches
    got = fbs.fb_scans_cuda(*args, beam=beam, path=path, xi=False)
    assert fbs.KERNEL.launches == before + 1
    torch.cuda.synchronize()
    assert got[3] is None
    for g, r in zip(got[:3], full[:3]):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_herest_on_card_equals_cpu(tmp_path, monkeypatch):
    """One iteration on each device; the kernel launches once per FB
    batch; parameters agree as the CPU tests hold the port to htk_tpu
    (tests/test_torch_herest.py)."""
    need_card()
    import numpy as np

    from htk_tpu_torch.io.mmf import load_mmf
    from htk_tpu_torch.models.hmmset import compile_hmmset
    from htk_tpu_torch.synth import write_system
    from htk_tpu_torch.tools import herest

    s = write_system(str(tmp_path), n_words=12, n_phones=8, n_tied=30,
                     n_mix=2, n_utts=5, min_frames=60, max_frames=150,
                     fanout=4, seed=3)
    out = {}
    for dev in ("cuda", "cpu"):
        monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", dev)
        d = str(tmp_path / dev)
        before = fbs.KERNEL.launches
        assert herest.run(["-H", s.hmmdefs, "-M", d, "-b", "2", "-S",
                           s.train_scp, "-I", s.train_mlf,
                           s.hmmlist]) == 0
        launches = fbs.KERNEL.launches - before
        assert (launches > 0) == (dev == "cuda")
        out[dev] = compile_hmmset(load_mmf([d + "/hmmdefs"]))
    assert launches == 0
    for k in ("means", "variances"):
        ref = getattr(out["cpu"], k)
        np.testing.assert_allclose(getattr(out["cuda"], k), ref, rtol=1e-4,
                                   atol=1e-3 * float(np.abs(ref).max()))
    np.testing.assert_allclose(np.exp(out["cuda"].log_transp),
                               np.exp(out["cpu"].log_transp), rtol=1e-4,
                               atol=1e-7)
