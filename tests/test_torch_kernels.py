"""The port's decode kernel wrapper (htk_tpu_torch/ops/decode_scan.py).

No JAX here, so the `cuda`-marked tests also run on a machine with a card
and no JAX (`--noconftest`; see README). On the CPU: the dispatcher takes
the plain version for CPU tensors and counts no launch, and the wrapper
refuses what the kernel cannot take. On the card: the kernel equals the
plain version (live scores within 1e-5, word-link records exactly), on
random nets and with tie-heavy integer scores, and HVite on the card
writes the same rec.mlf as on the CPU.
"""

import pytest
import torch

from htk_tpu_torch.ops import decode_scan as ds
from htk_tpu_torch.synth import random_decode_net
from htk_tpu_torch.utils.errors import HTKError
from htk_tpu_torch.utils.logmath import LZERO


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
