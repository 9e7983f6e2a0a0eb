"""The max-plus cross-word product of the port (htk_tpu_torch/ops/maxplus.py
and ops/tropical.py) against htk_tpu's, on the CPU.

The same numpy operands (synth.random_maxplus_operands: normal scores,
tie-heavy integer scores, and batch rows whose every source is dead) go
through the port's plain version and through the JAX package's functions:

  floor=True   against `htk_tpu/ops/maxplus_pallas.py : maxplus_matvec` in
               interpret mode (the TPU kernel's contract, floored at
               (LZERO, 0))
  floor=False  against the decoder's dense XLA branch
               (`htk_tpu/algo/decode.py : _make_uniform_step`, :657-660),
               jnp.max and jnp.argmax over the (B, C, C) broadcast

and the tropical wrappers against `tropical_matvec_argmax(use_pallas=
False)` (the reference's plain branch) and, after `pad_tropical_operand`,
against `_tropical_pallas_t` in interpret mode, which runs on the CPU.
Values and arguments must be exactly equal: every candidate is one fp32
add in both packages. The dispatchers take the plain versions on CPU
tensors and count no launch; the kernel wrapper refuses CPU tensors.

The CUDA kernel (csrc/maxplus.cu) splits the source range into chunks
and each chunk among a block's warps, then merges the partial maxima in
ascending order with a strict `>`; a torch emulation of that split and
merge equals `maxplus_plain` exactly at 1, 2, 3 and 7 chunks, with chunk
edges on tied maxima. `grid_chunks` covers the card twice over.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htk_tpu.ops import tropical_pallas as jtrop
from htk_tpu.ops.maxplus_pallas import maxplus_matvec as jax_maxplus
from htk_tpu_torch.ops import maxplus as mp
from htk_tpu_torch.ops import tropical as trop
from htk_tpu_torch.synth import random_maxplus_operands
from htk_tpu_torch.utils.logmath import LZERO

from _torch_compare import one_torch_thread  # noqa: F401


MODES = {"normal": {}, "ties": {"ties": True}, "dead": {"dead_rows": 1}}


def operands(B, C, mode, seed=0):
    return random_maxplus_operands(seed, B=B, C=C, **MODES[mode])


def assert_equal(got, ref_val, ref_arg):
    val, arg = got
    assert arg.dtype == torch.int32
    np.testing.assert_array_equal(val.numpy(), np.asarray(ref_val))
    np.testing.assert_array_equal(arg.numpy(), np.asarray(ref_arg))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("B,C", [(1, 1), (1, 200), (1, 130), (5, 1),
                                 (5, 200), (5, 130)])
def test_floored_equals_pallas_kernel(B, C, mode):
    WE, tr = operands(B, C, mode)
    rv, ra = jax_maxplus(jnp.asarray(WE), jnp.asarray(tr), interpret=True)
    got = mp.maxplus_matvec(torch.as_tensor(WE), torch.as_tensor(tr))
    assert_equal(got, rv, ra)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("B,C", [(1, 1), (5, 200), (5, 130)])
def test_unfloored_equals_xla_branch(B, C, mode):
    WE, tr = operands(B, C, mode, seed=1)
    cand = jnp.asarray(WE)[:, :, None] + jnp.asarray(tr)[None]
    got = mp.maxplus(torch.as_tensor(WE), torch.as_tensor(tr), floor=False)
    assert_equal(got, jnp.max(cand, axis=1), jnp.argmax(cand, axis=1))


def test_floor_contracts_differ_only_on_dead_targets():
    """All-dead rows: the floor gives (LZERO, 0), the raw max the
    dead candidates' max and its argmax; live rows agree."""
    WE, tr = operands(4, 60, "dead", seed=2)
    WE, tr = torch.as_tensor(WE), torch.as_tensor(tr)
    fv, fa = mp.maxplus_plain(WE, tr, floor=True)
    rv, ra = mp.maxplus_plain(WE, tr, floor=False)
    assert torch.equal(fv[:3], rv[:3]) and torch.equal(fa[:3], ra[:3])
    assert bool((fv[3] == LZERO).all()) and bool((fa[3] == 0).all())
    assert bool((rv[3] < LZERO).all())


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("B,C", [(1, 1), (3, 130), (8, 200)])
def test_tropical_equals_reference(B, C, mode):
    """tropical_matvec_argmax against the reference's plain branch: equal
    with use_pallas=False; by default equal to it floored at (LZERO, 0),
    the TPU kernel's contract."""
    WE, tr = operands(B, C, mode, seed=3)
    rv, ra = (np.asarray(x) for x in jtrop.tropical_matvec_argmax(
        jnp.asarray(WE), jnp.asarray(tr), use_pallas=False))
    WEt, trt = torch.as_tensor(WE), torch.as_tensor(tr)
    assert_equal(trop.tropical_matvec_argmax(WEt, trt, use_pallas=False),
                 rv, ra)
    low = rv <= LZERO
    assert_equal(trop.tropical_matvec_argmax(WEt, trt),
                 np.where(low, np.float32(LZERO), rv),
                 np.where(low, 0, ra))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tropical_padded_equals_pallas_kernel(mode):
    """pad_tropical_operand + tropical_matvec_argmax_padded against the
    TPU kernel `_tropical_pallas_t` in interpret mode on the same padded
    operands (Bp = 8, Cp = 256): padded operand and outputs equal."""
    B, C = 5, 130
    WE, tr = operands(B, C, mode, seed=4)
    Bp, Cp = 8, 256
    WEp = np.full((Bp, Cp), LZERO, np.float32)
    WEp[:B, :C] = WE
    tT_ref = jtrop.pad_tropical_operand(jnp.asarray(tr), C)
    oT, aT = jtrop._tropical_pallas_t(jnp.asarray(WEp), tT_ref,
                                      interpret=True)
    tT = trop.pad_tropical_operand(torch.as_tensor(tr), C)
    np.testing.assert_array_equal(tT.numpy(), np.asarray(tT_ref))
    got = trop.tropical_matvec_argmax_padded(torch.as_tensor(WEp), tT)
    assert_equal(got, np.asarray(oT).T, np.asarray(aT).T)


def test_tropical_untransposes_once_per_operand():
    WE, tr = operands(2, 20, "normal", seed=5)
    tT = trop.pad_tropical_operand(torch.as_tensor(tr))
    WEp = torch.full((2, 128), LZERO)
    WEp[:, :20] = torch.as_tensor(WE)
    first = trop.tropical_matvec_argmax_padded(WEp, tT)
    held = tT._maxplus_rows[1]
    again = trop.tropical_matvec_argmax_padded(WEp, tT)
    assert tT._maxplus_rows[1] is held
    assert torch.equal(first[0], again[0])
    tT[:, 0] += 1.0  # an in-place change refreshes the held copy
    trop.tropical_matvec_argmax_padded(WEp, tT)
    assert tT._maxplus_rows[1] is not held


def test_dispatch_cpu_takes_plain_and_counts_no_launch():
    WE, tr = (torch.as_tensor(a) for a in operands(3, 40, "ties"))
    before = (mp.KERNEL.launches, trop.LAUNCHES.launches)
    out = mp.maxplus(WE, tr, floor=True)
    ref = mp.maxplus_plain(WE, tr, floor=True)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    trop.tropical_matvec_argmax(WE, tr)
    assert (mp.KERNEL.launches, trop.LAUNCHES.launches) == before


def test_operand_checks_raise():
    WE, tr = (torch.as_tensor(a) for a in operands(3, 40, "normal"))
    with pytest.raises(ValueError):
        mp.maxplus(WE, tr[:, :30].contiguous(), floor=True)  # not (C, C)
    with pytest.raises(ValueError):
        mp.maxplus(WE[0], tr, floor=True)  # not (B, C)
    with pytest.raises(TypeError):
        mp.maxplus(WE.double(), tr, floor=True)
    with pytest.raises(ValueError):
        mp.maxplus(WE, tr.t(), floor=True)  # not contiguous
    with pytest.raises(ValueError):  # no implementation on this device
        mp.maxplus(WE.to("meta"), tr.to("meta"), floor=True)
    with pytest.raises(ValueError):  # the kernel takes CUDA tensors only
        mp.maxplus_cuda(WE, tr, floor=True)


def split_merge(WE, trans, floor, chunks):
    """The kernel's split of the source rows, emulated: chunk k holds rows
    [C k / chunks, C (k+1) / chunks), cut again among the block's warps;
    each range's first maximum (seeded at (-inf, 0)) is merged in
    ascending order with a strict `>`, from the floor contract's seed."""
    B, C = WE.shape
    acc = torch.full((B, C), LZERO if floor else -np.inf)
    arg = torch.zeros((B, C), dtype=torch.int32)
    for k in range(chunks):
        c0, c1 = C * k // chunks, C * (k + 1) // chunks
        for w in range(mp.WARPS):
            r0 = c0 + (c1 - c0) * w // mp.WARPS
            r1 = c0 + (c1 - c0) * (w + 1) // mp.WARPS
            if r0 == r1:
                continue
            v, a = torch.max(WE[:, r0:r1, None] + trans[None, r0:r1], dim=1)
            win = v > acc
            acc = torch.where(win, v, acc)
            arg = torch.where(win, (a + r0).to(torch.int32), arg)
    return acc, arg


def tied_across_edges(C, chunks):
    """Every target's maximum reached at the last row of each chunk and
    the first row of the next (and nowhere else): only the first-maximum
    rule across the merge picks the right one."""
    WE = np.zeros((3, C), np.float32)
    WE[2] = 2 * LZERO  # a dead row: the floor contracts differ there
    trans = np.full((C, C), -5.0, np.float32)
    for k in range(1, chunks):
        e = C * k // chunks
        trans[e - 1] = trans[e] = 1.0
    return WE, trans


@pytest.mark.parametrize("chunks", [1, 2, 3, 7])
@pytest.mark.parametrize("floor", [False, True])
def test_split_merge_equals_plain(chunks, floor):
    cases = [operands(B, C, mode, seed=6 + chunks)
             for mode in ("ties", "dead") for B, C in ((1, 1), (5, 130),
                                                       (8, 200), (3, 1000))]
    cases.append(tied_across_edges(210, max(chunks, 2)))
    for WE, tr in cases:
        WE, tr = torch.as_tensor(WE), torch.as_tensor(tr)
        got = split_merge(WE, tr, floor, chunks)
        ref = mp.maxplus_plain(WE, tr, floor)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_grid_chunks_cover_the_card():
    """At least MIN_BLOCKS blocks where the source range allows it (one
    row a warp at least), one chunk for tiny shapes."""
    for B, C in ((8, 1000), (1, 1000), (17, 2050), (8, 200), (1, 1)):
        k = mp.grid_chunks(B, C)
        blocks = -(-C // mp.COLS) * -(-B // mp.BATCH) * k
        assert 1 <= k <= max(1, C // mp.WARPS)
        assert blocks >= mp.MIN_BLOCKS or k == max(1, C // mp.WARPS)
    assert mp.grid_chunks(8, 1000) == 9  # 288 blocks at the decoder's shape
