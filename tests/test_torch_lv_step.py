"""The uniform step's frame loop (htk_tpu_torch/algo/decode.py:
`_uniform_scan`, `_PlainScan`, `_KernelScan`) and the card's step kernel
(ops/lv_step.py, csrc/lv_step.cu).

No JAX here, so the `cuda`-marked tests also run on a machine with a card
and no JAX (`--noconftest`; see README). On the CPU: the dispatcher takes
the plain step on CPU tensors and counts no launch (and the `htk.lv.step`
spans count no kernel step); the wrapper refuses CPU tensors, wrong
dtypes, bad shapes and non-contiguous tables; the plain loop's planes,
written into (B, T, C) planes allocated once, equal the stacked planes of
the step byte for byte on the factored exact, top-A, adaptive, trigram
and dense (max-plus and top-A) legs. On the card: the kernel's loop
equals the plain loop on the same card tensors bit for bit in v, the
records and all three planes, over small synthetic uniform nets: every
cross leg, with and without a beam that binds, rows of 16, 15, 40, 64
and 72 states (two states a lane, and a state a lane in chunks of 32),
bands of 1, 2 and 3 shifts, tie-heavy integer tables and scores
(ties in the word ends and in the back-off max), hybrid-like state scores
of either sign, OutP fed as strided chunks of a longer tensor, and grids
that cut the batch rows into chunks (a net's rows repeated until
`batch_chunk` picks them); the factored exact leg's frame is one segmax
and one step launch.
"""

import numpy as np
import pytest
import torch

from htk_tpu_torch.algo import decode as dec
from htk_tpu_torch.algo.lvnet import compile_lv_loop
from htk_tpu_torch.ops import lv_step as lvs
from htk_tpu_torch.ops import xw_gather as xg
from htk_tpu_torch.synth import lv_system
from htk_tpu_torch.utils import metrics
from htk_tpu_torch.utils.logmath import LZERO

from _torch_compare import one_torch_thread  # noqa: F401

LM, WP = 12.0, -4.0
B, T = 5, 40
TOPA = 7


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The port's tools run on the card unless the CPU is asked for."""
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def system():
    return lv_system(60, n_tied=40, n_mix=2, n_utts=2, min_frames=30,
                     max_frames=40, lm_order=3, seed=3)


_NETS = {}


def net_of(system, leg, S=16):
    """The small system's net for a leg: dense for "dense*", trigram-
    guided for "trigram", factored otherwise; S from pad_multiple."""
    key = (leg, S)
    if key not in _NETS:
        kw = dict(factored=not leg.startswith("dense"),
                  trigram=leg == "trigram",
                  pad_multiple={16: 4, 15: 1, 40: 40, 64: 64, 72: 72}[S])
        n = compile_lv_loop(system.words, system.vocab, system.comp,
                            lm=system.lm, **kw)
        assert n.uniform_width == S
        _NETS[key] = n
    return _NETS[key]


def max_active(leg):
    return {"topa": TOPA, "adaptive": -TOPA, "dense_topa": TOPA}.get(leg)


def _ints(x, rng):
    """Tie-heavy tables: finite entries as small integers, LZERO kept."""
    return torch.where(x > LZERO / 2, torch.as_tensor(
        rng.integers(-3, 1, x.shape), dtype=torch.float32), x)


def operands(net, dev, K=None, ties=False, scores="gmm", seed=0,
             noslots=False):
    """decode_scan_uniform_batch's operands on `dev`: (outp (B, T, Ns),
    the step's tables, LM-scaled) from the net, the band cut to K shifts
    or widened to 3 by a skip (LZERO before each row's third state),
    integer tables and scores under `ties`, scores of either sign like a
    hybrid's under scores="hybrid"; `noslots` empties the explicit
    bigram leg's segments."""
    rng = np.random.default_rng(seed)
    d = dec._net_dev(net, "cpu")
    S, C = net.uniform_width, net.n_nodes
    band = d["band"]
    if K is not None and K < band.shape[0]:
        band = band[:K].contiguous()
    elif K is not None and K > band.shape[0]:
        skip = torch.full((C, S), LZERO)
        skip[:, 2:] = torch.as_tensor(rng.uniform(-4, -1, (C, S - 2)),
                                      dtype=torch.float32)
        skip = torch.where(band[1].reshape(C, S) > LZERO / 2, skip, LZERO)
        band = torch.cat([band, skip.reshape(1, -1)])
    tabs = dict(band=band, a0=d["a0"], aE=d["aE"], bonus=d["bonus"],
                trans=d["trans"] * LM, start=d["start"] * LM)
    xw = dec._scale_xw(d.get("xw"), LM)
    x3 = dec._scale_xw3(d.get("xw3"), LM)
    if noslots:
        xw = dict(xw, preds=xw["preds"][:0], scores=xw["scores"][:0],
                  seg_off=xw["seg_off"][:1], out_row=xw["out_row"][:0])
    if ties:
        tabs = {k: _ints(v, rng) for k, v in tabs.items()}
        if xw is not None:
            xw = {k: (_ints(v, rng) if k in ("bow", "uni", "scores",
                                              "succ_p", "marg")
                      and v is not None else v) for k, v in xw.items()}
    Ns = S * C
    if ties:
        outp = rng.integers(-4, 1, (B, T, Ns)).astype(np.float32)
    elif scores == "hybrid":
        outp = rng.uniform(-90, 13, (B, T, Ns)).astype(np.float32)
    else:
        outp = rng.uniform(-30, -1, (B, T, Ns)).astype(np.float32)

    def to(x):
        if isinstance(x, dict):
            return {k: to(v) for k, v in x.items()}
        return x.to(dev) if torch.is_tensor(x) else x

    return to(torch.as_tensor(outp)), to(tabs), to(xw), to(x3)


def scan(cls, outp, tabs, xw, x3, S, beam, ma, chunk=None):
    """A `cls` loop over outp, fed in chunks of `chunk` frames (strided
    slices of outp) or whole."""
    Bn, Tn, Ns = outp.shape
    args = (Bn, Tn, Ns, tabs["band"], tabs["a0"], tabs["aE"], S,
            tabs["bonus"], tabs["trans"], tabs["start"], WP,
            dec._BEAM_OFF if beam is None else beam, ma, xw, x3,
            outp.device)
    s = cls(*args)
    ch = chunk or Tn
    for t0 in range(0, Tn, ch):
        s.frames(outp[:, t0:t0 + ch], t0)
    (v, rec), planes = s.result()
    return (v, rec, *planes)


def stacked(outp, tabs, xw, x3, S, beam, ma):
    """The plain step driven frame by frame, its planes stacked."""
    Bn, Tn, Ns = outp.shape
    step = dec._make_uniform_step(
        Bn, Ns, tabs["band"], tabs["a0"], tabs["aE"], S, tabs["bonus"],
        tabs["trans"], tabs["start"], WP,
        dec._BEAM_OFF if beam is None else beam, ma, xw, x3)
    carry = dec._uniform_init(Bn, Ns, outp.device)
    recs = []
    for t in range(Tn):
        carry, r = step(carry, outp[:, t], t)
        recs.append(r)
    return (*carry, *(torch.stack(p, dim=1) for p in zip(*recs)))


def assert_bits(got, ref):
    for name, a, b in zip(("v", "rec", "WEs", "pwns", "pwts"), got, ref):
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name


LEGS = ("exact", "topa", "adaptive", "trigram", "dense_maxplus",
        "dense_topa")


# ---------------------------------------------------------------- CPU

def test_dispatch_cpu_takes_plain_and_counts_no_launch(system):
    net = net_of(system, "exact")
    before = lvs.KERNEL.launches
    with metrics.recording():
        dec.decode_batch(net, system.comp, system.feats, LM, WP,
                         device="cpu")
        recs = list(metrics.RECORDER.records)
    assert lvs.KERNEL.launches == before
    steps = [r.counts for r in recs if r.name == "htk.lv.step"]
    assert steps and all(c["kernel_steps"] == 0 and c["frame_steps"] > 0
                         for c in steps)
    outp, tabs, xw, x3 = operands(net, "cpu")
    s = dec._uniform_scan(B, T, outp.shape[2], tabs["band"], tabs["a0"],
                          tabs["aE"], 16, tabs["bonus"], tabs["trans"],
                          tabs["start"], WP, dec._BEAM_OFF, None, xw, x3,
                          "cpu")
    assert type(s) is dec._PlainScan and not s.kernel


@pytest.mark.parametrize("leg", LEGS)
@pytest.mark.parametrize("beam", [None, 40.0])
def test_plain_planes_equal_stacked_planes(system, leg, beam):
    """The plain loop's preallocated planes and carry equal the step's
    stacked planes byte for byte."""
    net = net_of(system, leg)
    outp, tabs, xw, x3 = operands(net, "cpu", ties=leg == "topa")
    got = scan(dec._PlainScan, outp, tabs, xw, x3, 16, beam,
               max_active(leg), chunk=8)
    assert_bits(got, stacked(outp, tabs, xw, x3, 16, beam,
                             max_active(leg)))


def test_plain_planes_equal_decode_scan_uniform_batch(system):
    """decode_scan_uniform_batch runs the same loop: its records are the
    loop's unpacked."""
    net = net_of(system, "exact")
    outp, tabs, xw, x3 = operands(net, "cpu")
    (v, wn, wt), (WE, pwn, pwt) = dec.decode_scan_uniform_batch(
        outp, tabs["band"], tabs["a0"], tabs["aE"], 16, tabs["bonus"],
        tabs["trans"], tabs["start"], WP, dec._BEAM_OFF, None, xw, x3)
    ref = stacked(outp, tabs, xw, x3, 16, None, None)
    assert_bits((v, ref[1], WE, pwn, pwt), ref)
    assert torch.equal(torch.stack([wn, wt]), torch.stack(dec._unpack(
        ref[1])))


def _tables(C=6, S=4, K=2):
    Ns = C * S
    return dict(band=torch.zeros((K, Ns)), a0=torch.zeros(Ns),
                aE=torch.zeros(Ns), bonus=torch.zeros(C),
                start=torch.zeros(C), S=S, B=2, T=5, word_pen=0.0,
                beam=None)


def test_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        lvs.LvSteps(**_tables())


@pytest.mark.parametrize("name", ["band", "a0", "aE", "bonus", "start"])
def test_wrapper_refuses_wrong_dtypes(name):
    kw = _tables()
    kw[name] = kw[name].double()
    with pytest.raises(TypeError):
        lvs.LvSteps(**kw)


@pytest.mark.parametrize("bad", ["a0", "bonus", "rows", "band", "uni",
                                 "wide", "start", "frames"])
def test_wrapper_refuses_bad_shapes(bad):
    kw = _tables()
    if bad == "a0":
        kw["a0"] = torch.zeros(23)
    elif bad == "bonus":
        kw["bonus"] = torch.zeros(7)
    elif bad == "rows":
        kw["S"] = 5  # 24 states are no rows of 5
    elif bad == "band":
        kw["band"] = torch.zeros(24)
    elif bad == "uni":
        kw["uni"] = torch.zeros(6)  # without bow
    elif bad == "wide":
        kw["band"] = torch.zeros((lvs.K_MAX + 1, 24))
    elif bad == "start":
        kw["start"] = torch.zeros((6, 1))
    else:
        kw["T"] = (1 << lvs.TBITS) + 1
    with pytest.raises((ValueError, TypeError)):
        lvs.LvSteps(**kw)


@pytest.mark.parametrize("name", ["band", "a0", "bonus"])
def test_wrapper_refuses_non_contiguous_tables(name):
    kw = _tables()
    x = kw[name]
    kw[name] = (torch.zeros(x.shape[::-1]).t() if x.dim() == 2
                else torch.zeros(2 * x.shape[0])[::2])
    assert kw[name].shape == x.shape and not kw[name].is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        lvs.LvSteps(**kw)


def test_warp_rows_and_batch_chunks():
    assert [lvs.warp_rows(s) for s in (1, 2, 4, 15, 16, 40, 64, 66)] == [
        1, 32, 16, 1, 4, 1, 1, 1]
    assert lvs.warp_rows(12) == 4 and lvs.warp_rows(34) == 1
    # the cell: 20,000 rows of 16 in 625 blocks a batch chunk
    assert lvs.batch_chunk(13, 20000, 16, 132) == 4
    assert lvs.batch_chunk(13, 60, 16, 132) == 1
    assert lvs.batch_chunk(1, 20000, 16, 132) == 1
    assert lvs.batch_chunk(100, 200000, 16, 132) == 25


# ---------------------------------------------------------------- card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def both(system, leg, dev, S=16, beam=None, chunk=None, **kw):
    net = net_of(system, leg, S)
    return both_on(*operands(net, dev, **kw), S, beam, max_active(leg),
                   chunk)


def both_on(outp, tabs, xw, x3, S, beam, ma, chunk=None):
    before = lvs.KERNEL.launches
    got = scan(dec._KernelScan, outp, tabs, xw, x3, S, beam, ma, chunk)
    torch.cuda.synchronize(outp.device)
    assert lvs.KERNEL.launches - before == outp.shape[1] * (2 if beam
                                                            else 1)
    ref = scan(dec._PlainScan, outp, tabs, xw, x3, S, beam, ma, chunk)
    assert_bits(got, ref)
    return got


def tiled_operands(system, C, dev, ties, frames=T):
    """operands() of the factored net without explicit bigrams, its rows
    repeated to C rows (successor targets moved with their copy, those
    past the last row to the pad row C), and `frames` frames of scores:
    a vocabulary large enough that `batch_chunk` cuts the batch rows."""
    net = net_of(system, "exact")
    _outp, tabs, xw, _x3 = operands(net, "cpu", ties=ties, noslots=True)
    C0, S = net.n_nodes, net.uniform_width
    rows = torch.arange(C) % C0
    states = (rows[:, None] * S + torch.arange(S)).reshape(-1)
    tabs = dict(tabs, band=tabs["band"][:, states].contiguous(),
                a0=tabs["a0"][states], aE=tabs["aE"][states],
                bonus=tabs["bonus"][rows], start=tabs["start"][rows])
    sj = xw["succ_j"][rows]
    copy = (torch.arange(C) // C0 * C0)[:, None]
    sj = torch.where(sj == C0, C, sj + copy).clamp(max=C)
    xw = dict(xw, bow=xw["bow"][rows], uni=xw["uni"][rows],
              marg=xw["marg"][rows], succ_j=sj, succ_p=xw["succ_p"][rows])
    g = torch.Generator(device=dev).manual_seed(C)
    shape = (B, frames, C * S)
    outp = (torch.randint(-4, 1, shape, generator=g, device=dev).float()
            if ties else torch.empty(shape, device=dev).uniform_(
                -30, -1, generator=g))
    return (outp, {k: v.to(dev) for k, v in tabs.items()},
            {k: (v.to(dev) if torch.is_tensor(v) else v)
             for k, v in xw.items()}, None)


@pytest.mark.cuda
@pytest.mark.parametrize("leg", LEGS)
@pytest.mark.parametrize("beam", [None, 40.0])
@pytest.mark.parametrize("ties", [False, True])
def test_kernel_equals_plain_on_card(system, card, leg, beam, ties):
    both(system, leg, card, beam=beam, ties=ties)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [15, 40, 64, 72])
@pytest.mark.parametrize("leg", ["exact", "dense_maxplus"])
@pytest.mark.parametrize("beam", [None, 40.0])
def test_kernel_rows_of_any_width_on_card(system, card, S, leg, beam):
    both(system, leg, card, S=S, beam=beam, ties=True)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("S", [16, 15, 40, 72])
def test_kernel_bands_on_card(system, card, K, S):
    both(system, "exact", card, S=S, K=K, beam=None, ties=True)
    both(system, "topa", card, S=S, K=K, beam=40.0, ties=False)


@pytest.mark.cuda
@pytest.mark.parametrize("beam", [None, 40.0])
def test_kernel_hybrid_scores_and_strided_chunks_on_card(system, card,
                                                         beam):
    both(system, "exact", card, beam=beam, scores="hybrid", chunk=8)
    both(system, "trigram", card, beam=beam, scores="hybrid", chunk=16)


@pytest.mark.cuda
@pytest.mark.parametrize("bsz", [1, 2, 3, 5])
def test_kernel_batch_chunks_on_card(system, card, bsz):
    """The C at which `batch_chunk` gives `bsz` batch rows a block on this
    card, with ties: the exact leg, and the top-A leg's (m, an) planes
    with a beam."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    C = min(32 * n - 5 for n in range(1, lvs.BLOCKS_PER_SM * sms + 1)
            if lvs.batch_chunk(B, 32 * n - 5, 16, sms) == bsz)
    both_on(*tiled_operands(system, C, card, ties=True), 16, None, None)
    both_on(*tiled_operands(system, C, card, ties=True), 16, 40.0, TOPA)


@pytest.mark.cuda
def test_kernel_factored_leg_without_explicit_bigrams_on_card(system, card):
    both(system, "exact", card, noslots=True, ties=True)


@pytest.mark.cuda
def test_exact_frame_is_segmax_and_one_step_launch_on_card(system, card):
    """decode_batch on the card: one segmax and one lv_step launch a
    padded frame, kernel_steps == frame_steps, and the CPU's words."""
    net = net_of(system, "exact")
    seg0, lv0 = xg.SEGMAX.launches, lvs.KERNEL.launches
    with metrics.recording():
        res = dec.decode_batch(net, system.comp, system.feats, LM, WP,
                               device="cuda")
        torch.cuda.synchronize()
        recs = list(metrics.RECORDER.records)
    frames = sum(r.counts["frame_steps"] for r in recs
                 if r.name == "htk.lv.step")
    assert frames > 0
    assert sum(r.counts["kernel_steps"] for r in recs
               if r.name == "htk.lv.step") == frames
    assert xg.SEGMAX.launches - seg0 == frames
    assert lvs.KERNEL.launches - lv0 == frames
    ref = dec.decode_batch(net, system.comp, system.feats, LM, WP,
                           device="cpu")
    for a, b in zip(res, ref):
        assert (a.words, a.times) == (b.words, b.times)
