"""The hybrid LSTMP-HMM (models/ann.LSTMPLayer, algo/nnet.hybrid_outp's
stepped path, ops/lstmp.py and csrc/lstmp_cell.cu) on the CPU, against
the plain float64 reference (tests/plain_lstmp.py), on a seeded net of 2
LSTMP layers of 16 cells with a projection of 8, 7 targets and an output
delay of 2:

  - `hybrid_outp` matches the reference on one utterance; the same run
    with the GEMMs' inputs rounded to TF32 does not;
  - a padded batch of 3 lengths gives each utterance its own rows: within
    the reference's tolerance of its rows alone, and bit for bit
    unchanged when another utterance's frames or the padding change;
  - the delay is exact: the scores a frame off, and a net whose delay is
    one off, fail the tolerance;
  - the ANN file round-trips with LSTMP layers (`init_ann` builds them
    too), a DNN file is written as before, and a malformed LSTMP entry is
    refused;
  - HDecode -N with the LSTMP net writes the words and lattices that the
    same run writes with `hybrid_outp` replaced by the reference's
    scores (what `generate_lattice_batch` is fed);
  - HNTrainSGD and HVite live mode refuse a recurrent net.

No JAX here, so the `cuda`-marked tests also run on a machine with a card
and no JAX (`--noconftest`; see README): the kernel equals the plain cell
bit for bit at the benchmark's shape (B = 13, n_c = 832) and at ragged
ones, one launch a step, and the stepped path on the card matches the
reference as on the CPU.
"""

import os

import numpy as np
import pytest
import torch

from htk_tpu_torch.algo import nnet
from htk_tpu_torch.models import ann as ann_mod
from htk_tpu_torch.models.ann import (ANNDef, Layer, LSTMPLayer, load_ann,
                                      save_ann)
from htk_tpu_torch.ops import lstmp as lo
from htk_tpu_torch.utils import metrics
from htk_tpu_torch.utils.errors import HTKError

import plain_lstmp as pl
from _torch_compare import assert_slf_close, one_torch_thread  # noqa: F401

D, N_C, N_R, K, DELAY = 6, 16, 8, 7, 2
F32_U = 2.0 ** -24
# |port - reference| over the output layer's rounding, 2^-24 x sum_k
# |W_jk h_k|: the float32 GEMMs and cells of both layers reach the output
# through W, a few roundings of h each (the recurrence is contractive, so
# they do not grow with the frames), plus the log-softmax's and the
# prior's roundings of the score. Measured on the CPU: at most 26.6 of
# these units over 20 seeded nets (3 utterances each, decoded alone; up
# to 21.2 in a padded batch); the same nets with the GEMMs' inputs
# rounded to TF32 (2^-11) read 30,000 to 64,000.
TOL_U = 128.0


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


def make_lstmp(n_out=K, seed=0, delay=DELAY, n_in=D):
    """2 LSTMP layers and a SOFTMAX output layer with the benchmark's
    kind of gains: large on W_x and the output, under 1 on the
    recurrence (contractive), +1 on the forget gates' biases."""
    rng = np.random.default_rng(seed)

    def normal(*shape, sd):
        return (rng.standard_normal(shape) * sd).astype(np.float32)

    layers, width = [], n_in
    for _ in range(2):
        b = normal(4 * N_C, sd=0.1)
        b[N_C:2 * N_C] += 1.0
        layers.append(LSTMPLayer(
            weight=normal(4 * N_C, width, sd=4 / np.sqrt(width)),
            recur=normal(4 * N_C, N_R, sd=0.5 / np.sqrt(N_R)),
            peep=normal(3, N_C, sd=0.1), bias=b,
            proj=normal(N_R, N_C, sd=0.75 / np.sqrt(N_C))))
        width = N_R
    layers.append(Layer(weight=normal(n_out, N_R, sd=8 / np.sqrt(N_R)),
                        bias=normal(n_out, sd=1.0), activation="SOFTMAX"))
    return ANNDef(name="lstmp", layers=layers, context=0, out_delay=delay,
                  target_priors=rng.dirichlet(np.ones(n_out)).astype(
                      np.float32),
                  target_names=[f"S{k}" for k in range(n_out)])


def plain_args(ann):
    hid = [("LSTMP", l.weight, l.recur, l.peep, l.bias, l.proj)
           if isinstance(l, LSTMPLayer) else (l.weight, l.bias, l.activation)
           for l in ann.layers[:-1]]
    return hid, (ann.layers[-1].weight, ann.layers[-1].bias)


def reference(ann, feats, delay=None):
    """The reference's (scores, output-layer scale) of one utterance."""
    hid, out = plain_args(ann)
    d = ann.out_delay if delay is None else delay
    return (pl.scores(hid, out, ann.target_priors, feats, ann.context, d),
            pl.output_scale(hid, out, feats, ann.context, d))


def gap(got, ann, feats, delay=None):
    """max |got - reference| in TOL_U's units."""
    want, scale = reference(ann, feats, delay)
    return float(((torch.as_tensor(got).to(torch.float64) - want).abs()
                  / (F32_U * scale)).max())


@pytest.fixture(scope="module")
def net():
    return make_lstmp()


@pytest.fixture(scope="module")
def utts():
    rng = np.random.default_rng(7)
    return [(rng.standard_normal((n, D)) * 2).astype(np.float32)
            for n in (23, 40, 31)]


def padded(feats, T=48):
    fb = np.zeros((len(feats), T, D), np.float32)
    for b, f in enumerate(feats):
        fb[b, :len(f)] = f
    return fb


def test_one_utterance_matches_the_plain_reference(net, utts):
    with metrics.recording():
        got = nnet.hybrid_outp(net, utts[1], device="cpu")
        s = metrics.summary()
    assert got.shape == (40, K)
    assert gap(got, net, utts[1]) <= TOL_U
    # the counters: the rows stepped (T + d) through every matrix
    mats = sum(a.size for l in net.layers[:2]
               for a in (l.weight, l.recur, l.proj)) + net.layers[2].weight.size
    fw = s["htk.ann.forward"]["counts"]
    assert fw["frames"] == 40 and fw["flops"] == 2 * mats * (40 + DELAY)
    rc = s["htk.ann.recur"]
    assert rc["count"] == 2 and rc["counts"] == {
        "frame_steps": 2 * (40 + DELAY), "kernel_steps": 0}


def _tf32(x):
    """x rounded to the nearest of TF32's 10 mantissa bits."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def test_tf32_inputs_fail_the_tolerance(net, utts, monkeypatch):
    mm = torch.mm

    def mm_tf32(a, b, out=None):
        return mm(_tf32(a), _tf32(b), out=out)

    def forward_tf32(params, acts, x, return_logits=True):
        (W, b), = params
        return _tf32(x) @ _tf32(W).T + b

    monkeypatch.setattr(torch, "mm", mm_tf32)
    monkeypatch.setattr(nnet, "forward", forward_tf32)
    got = nnet.hybrid_outp(net, utts[1], device="cpu")
    assert gap(got, net, utts[1]) > 100 * TOL_U


def test_a_padded_batch_gives_each_utterance_its_own_rows(net, utts):
    lens = [len(f) for f in utts]
    got = nnet.hybrid_outp(net, padded(utts), device="cpu", lengths=lens)
    assert got.shape == (3, 48, K) and bool(torch.isfinite(got).all())
    for b, f in enumerate(utts):
        alone = nnet.hybrid_outp(net, f, device="cpu")
        # the batch's step GEMMs have 3 rows, alone 1: the CPU's GEMM may
        # sum in another order, so the rows agree to float32 roundings
        assert gap(got[b, :lens[b]], net, f) <= TOL_U
        assert gap(alone, net, f) <= TOL_U
    # nothing leaks: another utterance's frames and the padding past an
    # end change no bit of an utterance's rows
    other = [f.copy() for f in utts]
    other[1] += 1.0
    fb = padded(other)
    fb[0, lens[0]:] = 9.0
    fb[2, lens[2]:] = -9.0
    moved = nnet.hybrid_outp(net, fb, device="cpu", lengths=lens)
    for b in (0, 2):
        assert torch.equal(moved[b, :lens[b]], got[b, :lens[b]])
    assert not torch.equal(moved[1, :lens[1]], got[1, :lens[1]])


def test_the_delay_is_exact(net, utts):
    f = utts[1]
    got = nnet.hybrid_outp(net, f, device="cpu")
    want, scale = reference(net, f)
    assert gap(got, net, f) <= TOL_U
    # the scores a frame off fail, either way
    for a, b in ((got[1:], slice(None, -1)), (got[:-1], slice(1, None))):
        off = ((a.to(torch.float64) - want[b]).abs() / (F32_U * scale[b]))
        assert float(off.max()) > 100 * TOL_U
    # a net whose delay is one off fails against the reference's
    for d in (DELAY - 1, DELAY + 1):
        net_d = ANNDef(name="d", layers=net.layers, context=0, out_delay=d,
                       target_priors=net.target_priors)
        assert gap(nnet.hybrid_outp(net_d, f, device="cpu"), net,
                   f) > 100 * TOL_U


def test_the_ann_file_round_trips_with_lstmp_layers(net, utts, tmp_path):
    p, q = str(tmp_path / "a"), str(tmp_path / "b")
    save_ann(net, p)
    back = load_ann(p)
    assert back.out_delay == DELAY and back.recurrent
    assert [type(l) for l in back.layers] == [type(l) for l in net.layers]
    for l, m in zip(net.layers, back.layers):
        for a, b in zip(ann_mod.ann_arrays(l), ann_mod.ann_arrays(m)):
            assert a.shape == b.shape
            np.testing.assert_allclose(b, a, rtol=6e-7, atol=0)  # %.6e
    save_ann(back, q)
    assert open(p).read() == open(q).read()
    assert gap(nnet.hybrid_outp(back, utts[0], device="cpu"), net,
               utts[0]) <= TOL_U


def test_init_ann_builds_lstmp_layers(utts, tmp_path):
    ann = ann_mod.init_ann("i", D, [N_C, N_C], K, context=0,
                           activation="LSTMP", projection=N_R,
                           out_delay=DELAY, seed=3)
    assert [type(l) for l in ann.layers] == [LSTMPLayer, LSTMPLayer, Layer]
    assert (ann.in_dim, ann.out_dim, ann.out_delay) == (D, K, DELAY)
    assert ann.layers[1].weight.shape == (4 * N_C, N_R)
    assert ann.layers[1].proj.shape == (N_R, N_C)
    ann.target_priors = np.full(K, 1.0 / K, np.float32)
    p = str(tmp_path / "i")
    save_ann(ann, p)
    back = load_ann(p)
    got = nnet.hybrid_outp(back, utts[0], device="cpu")
    assert got.shape == (len(utts[0]), K)
    # init_ann's small weights give logits of about 0.01: a score is the
    # log-softmax's -log 7 less the uniform prior's log(1/7), each rounded
    # at the size log 7, so a few roundings of log 7 in all (measured: at
    # most 1.7 over 20 seeds)
    want, _ = reference(back, utts[0])
    assert float((got.double() - want).abs().max()) <= 8 * F32_U * np.log(K)


def test_a_dnn_file_is_written_as_before(tmp_path):
    dnn = ANNDef(name="d", context=1, layers=[
        Layer(weight=np.array([[0.5, -1.0]], np.float32),
              bias=np.array([0.25], np.float32)),
        Layer(weight=np.array([[2.0], [-3.0]], np.float32),
              bias=np.zeros(2, np.float32), activation="SOFTMAX")],
        target_priors=np.array([0.5, 0.5], np.float32))
    p = str(tmp_path / "dnn")
    save_ann(dnn, p)
    assert open(p).read() == (
        '~N "d"\n<NUMLAYERS> 2 <CONTEXT> 1\n'
        "<LAYER> 1 <NUMUNITS> 1 <ACTIVATION> SIGMOID\n"
        "<WEIGHT> 1 2\n 5.000000e-01 -1.000000e+00\n"
        "<BIAS> 1\n 2.500000e-01\n"
        "<LAYER> 2 <NUMUNITS> 2 <ACTIVATION> SOFTMAX\n"
        "<WEIGHT> 2 1\n 2.000000e+00\n -3.000000e+00\n"
        "<BIAS> 2\n 0.000000e+00 0.000000e+00\n"
        "<TARGETPRIORS> 2\n 5.000000e-01 5.000000e-01\n")
    back = load_ann(p)
    assert back.out_delay == 0 and not back.recurrent


def test_a_malformed_lstmp_entry_is_refused(net, tmp_path):
    p = str(tmp_path / "a")
    save_ann(net, p)
    text = open(p).read()
    cut = text.index("<PROJECTION>")
    with open(p, "w") as f:
        f.write(text[:cut] + text[text.index("<BIAS>", cut):])
    with pytest.raises(HTKError) as e:
        load_ann(p)
    assert e.value.code == 7711 and "<PROJECTION>" in str(e.value)


def test_the_cell_wrapper_refuses_bad_operands():
    gx = torch.zeros((3, 2, 4 * N_C))
    peep, bias = torch.zeros((3, N_C)), torch.zeros(4 * N_C)
    lo.CellSteps(gx, peep, bias)
    with pytest.raises(TypeError):
        lo.CellSteps(gx.double(), peep, bias)
    with pytest.raises(ValueError):
        lo.CellSteps(gx[:, :, :-1], peep, bias)
    with pytest.raises(ValueError):
        lo.CellSteps(gx.transpose(0, 1), peep, bias)
    with pytest.raises(ValueError):
        lo.CellSteps(gx, peep[:2], bias)
    with pytest.raises(ValueError):
        lo.CellSteps(gx, peep, bias).step(3)


def test_the_cpu_steps_launch_no_kernel(net, utts):
    before = lo.KERNEL.launches
    nnet.hybrid_outp(net, utts[0], device="cpu")
    assert lo.KERNEL.launches == before


# -- the tools ---------------------------------------------------------------


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    """A 20-word `write_system` decoded on the LV loop, and an LSTMP ANN
    file with a target a state of its set."""
    from htk_tpu_torch.io.mmf import load_mmf
    from htk_tpu_torch.models.hmmset import compile_hmmset
    from htk_tpu_torch.synth import write_system

    root = str(tmp_path_factory.mktemp("lstmp_N"))
    s = write_system(root, n_words=20, n_phones=8, n_tied=400, n_mix=2,
                     n_utts=3, min_frames=60, max_frames=150, fanout=4,
                     seed=2, binary_mmf=False)
    comp = compile_hmmset(load_mmf([s.hmmdefs]))
    net = make_lstmp(comp.n_states, seed=4, n_in=comp.dim)
    save_ann(net, os.path.join(root, "lstmp"))
    with open(os.path.join(root, "lv.cfg"), "w") as f:
        f.write("HTKTPU: LVDECODE = T\n")
    return s


def _hdecode(s, out):
    from htk_tpu_torch.tools import hdecode

    os.makedirs(out, exist_ok=True)
    assert hdecode.run([
        "-C", os.path.join(s.root, "lv.cfg"), "-w", s.lm, "-s", "8", "-p",
        "-10", "-n", "30", "-N", os.path.join(s.root, "lstmp"), "-z", "lat",
        "-l", out, "-i", os.path.join(out, "rec.mlf"), "-H", s.hmmdefs,
        s.dict, s.hmmlist, *s.feats]) == 0
    return {f: open(os.path.join(out, f)).read()
            for f in sorted(os.listdir(out))}


def test_hdecode_N_equals_the_decoder_fed_the_references_scores(
        system, tmp_path, monkeypatch):
    from htk_tpu_torch.tools import hdecode

    s = system
    calls = []
    real = hdecode.hybrid_outp

    def counting(ann, feats, *a, **kw):
        calls.append(np.shape(feats))
        return real(ann, feats, *a, **kw)

    monkeypatch.setattr(hdecode, "hybrid_outp", counting)
    got = _hdecode(s, str(tmp_path / "port"))
    # one call a batch: the 3 files padded together
    assert calls and calls[0][0] == len(s.feats) and len(calls[0]) == 3

    def reference_scores(ann, feats, *a, lengths=None, **kw):
        x = np.asarray(feats, np.float32)
        if x.ndim == 2:
            return reference(ann, x)[0].to(torch.float32)
        out = np.zeros(x.shape[:2] + (ann.out_dim,), np.float32)
        for b, n in enumerate(lengths):
            sc = reference(ann, x[b, :n])[0].numpy()
            out[b, :n] = sc
            out[b, n:] = sc[-1]
        return torch.as_tensor(out)

    monkeypatch.setattr(hdecode, "hybrid_outp", reference_scores)
    want = _hdecode(s, str(tmp_path / "ref"))
    assert sorted(got) == sorted(want) and len(got) == len(s.feats) + 1
    assert got["rec.mlf"] == want["rec.mlf"]
    for f in got:
        if f.endswith(".lat"):
            assert_slf_close(got[f], want[f])


def test_training_and_live_mode_refuse_a_recurrent_net(system, tmp_path):
    from htk_tpu_torch.tools import hntrainsgd, hvite

    s = system
    ann = os.path.join(s.root, "lstmp")
    with pytest.raises(HTKError) as e:
        hntrainsgd.run(["-H", s.hmmdefs, "-N", ann, "-I", s.train_mlf,
                        "-M", str(tmp_path), "-e", "1", "-S", s.train_scp,
                        s.hmmlist])
    assert e.value.code == 7713 and "HNTrainSGD" in str(e.value)
    cfg = tmp_path / "live.cfg"
    cfg.write_text("HPARM: SOURCEKIND = HAUDIO\n"
                   f"HAUDIO: AUDIOSOURCE = {tmp_path / 'none.wav'}\n")
    with pytest.raises(HTKError) as e:
        hvite.run(["-C", str(cfg), "-w", s.wdnet, "-N", ann, "-H",
                   s.hmmdefs, s.dict, s.hmmlist])
    assert e.value.code == 7713 and "live" in str(e.value)


# -- the card ----------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/lstmp_cell.cu has no CPU mode")
    return torch.device("cuda")


def _cell_operands(B, n, seed, dev):
    g = torch.Generator().manual_seed(seed)

    def normal(*shape, sd=1.0):
        return (torch.randn(shape, generator=g) * sd).to(dev)

    return (normal(3, B, 4 * n, sd=3.0), normal(B, 4 * n), normal(B, n),
            normal(3, n, sd=0.5), normal(4 * n))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(13, 832), (8, 832), (1, 5), (3, 37),
                                 (40, 300)])
def test_the_kernel_equals_the_plain_cell(B, n):
    dev = _card()
    gx, gr, c, peep, bias = _cell_operands(B, n, B * 1000 + n, dev)
    cell = lo.CellSteps(gx, peep, bias)
    cell.gr.copy_(gr)
    cell.c[1].copy_(c)
    before = lo.KERNEL.launches
    cell.step(1)  # reads c[1], writes c[0]
    torch.cuda.synchronize(dev)
    assert lo.KERNEL.launches == before + 1
    ct, m = lo.lstmp_cell_plain(gx[1], gr, c, peep, bias)
    assert torch.equal(cell.c[0].view(torch.int32), ct.view(torch.int32))
    assert torch.equal(cell.m.view(torch.int32), m.view(torch.int32))


@pytest.mark.cuda
def test_the_stepped_path_on_the_card(net, utts):
    dev = _card()
    lens = [len(f) for f in utts]
    before = lo.KERNEL.launches
    with metrics.recording():
        got = nnet.hybrid_outp(net, padded(utts), device=dev, lengths=lens)
        rc = metrics.summary()["htk.ann.recur"]["counts"]
    torch.cuda.synchronize(dev)
    assert lo.KERNEL.launches - before == 2 * (48 + DELAY)
    assert rc == {"frame_steps": 2 * (48 + DELAY),
                  "kernel_steps": 2 * (48 + DELAY)}
    for b, f in enumerate(utts):
        assert gap(got[b, :lens[b]].cpu(), net, f) <= TOL_U
