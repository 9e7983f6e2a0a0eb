"""Times the two designs of the fb_scans kernel (htk_tpu_torch/ops/fb_scans.py,
csrc/fb_scans.cu) on one NVIDIA GPU.

    python3 scripts/fb_designs.py [--compare TREE] [--sweep]

Prints the card's name and power limit, then one JSON object a line:

  narrow     the narrow design with xi, as HERest launches it, at the
             shapes its callers give it: B=8/T=512/Q=192 (HERest's FB
             batch), B=256/T=32/Q=16 (HMMIRest's arc buckets) and
             B=1/T=504/Q=256 (mix_posteriors_utterance, FULLC, -K), on
             banded composites; "wall" the median ms of synchronised calls,
             "device" the ms a launch from CUDA events around back-to-back
             launches; each checked against the plain version once
  crossover  both designs without xi at T=256, B=1 and 8, Q from 512 to
             1,280, on banded composites and on ones with 2% random links
             (random_fb_operands), the two taken in turns
  sweep      (--sweep) the wide scan's constants kLongList and kStateCost:
             each variant is built from this checkout's csrc/fb_scans.cu
             into csrc/_build/ and its scan timed (CUDA events between the
             launch's parts) on a phone loop of 3,444 three-state models
             (B=1, T=504, Q=10,332), the variants in turns

--compare TREE runs the narrow shapes in child processes on TREE's
htk_tpu_torch and on this checkout's, in the order TREE, this, this, TREE,
and prints each tree's median and their ratio ("compare").
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(ROOT)  # after PYTHONPATH: --compare's children set it
NARROW_SHAPES = ((8, 512, 192), (256, 32, 16), (1, 504, 256))
CROSS_QS = (512, 640, 768, 896, 960, 1024, 1152, 1280)
SWEEP = ((64, 32), (16, 32), (256, 32), (1024, 32), (64, 8), (64, 128))
BAND = 6  # random_fb_operands' forward links


def emit(**kw):
    print(json.dumps(kw), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def operands(seed, B, T, Q, banded, dev):
    """random_fb_operands on `dev`; `banded` drops its random long links."""
    from htk_tpu_torch.synth import random_fb_operands
    from htk_tpu_torch.utils.logmath import LZERO
    ops = [torch.as_tensor(a, device=dev)
           for a in random_fb_operands(seed, B=B, T=T, Q=Q)]
    if banded:
        i = torch.arange(Q, device=dev)
        far = (i[None, :] - i[:, None]).abs() > BAND
        ops[1] = torch.where(far[None], torch.full_like(ops[1], LZERO),
                             ops[1]).contiguous()
    return ops


def wall_ms(fn, dev, reps=7):
    fn()
    torch.cuda.synchronize(dev)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def device_ms(fn, dev, n=20, reps=3):
    fn()
    torch.cuda.synchronize(dev)
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1) / n)
    return statistics.median(ts)


def narrow(dev):
    from htk_tpu_torch.ops import fb_scans as fbs
    for B, T, Q in NARROW_SHAPES:
        ops = operands(1, B, T, Q, True, dev)
        got = fbs.fb_scans_cuda(*ops, path="narrow")
        ref = fbs.fb_scans_plain(*ops)
        if not torch.allclose(got[2], ref[2], rtol=1e-5, atol=0):
            raise AssertionError(f"narrow B={B} T={T} Q={Q}: logP differs")
        fn = lambda: fbs.fb_scans_cuda(*ops, path="narrow")  # noqa: E731
        emit(kind="narrow", B=B, T=T, Q=Q, wall=wall_ms(fn, dev),
             device=device_ms(fn, dev))


def crossover(dev):
    from htk_tpu_torch.ops import fb_scans as fbs
    for fam in ("band", "links"):
        for B in (1, 8):
            for Q in CROSS_QS:
                ops = operands(2, B, 256, Q, fam == "band", dev)
                t = {"wide": [], "narrow": []}
                for path in ("wide", "narrow", "narrow", "wide"):
                    t[path].append(wall_ms(lambda: fbs.fb_scans_cuda(
                        *ops, path=path, xi=False), dev, reps=5))
                emit(kind="crossover", family=fam, B=B, T=256, Q=Q,
                     wide=min(t["wide"]), narrow=min(t["narrow"]),
                     plan=fbs.fb_plan(B, 256, Q, None))


def phone_loop(dev, models=3444, T=504):
    """fb_scans operands of a loop of `models` three-state models (self
    loops 0.6, next links 0.4, every exit to every entry), random outp."""
    from htk_tpu_torch.utils.logmath import LZERO
    Q = 3 * models
    A = torch.full((Q, Q), LZERO, device=dev)
    q = torch.arange(Q, device=dev)
    A[q, q] = float(np.log(0.6))
    nxt = q[q % 3 != 2]
    A[nxt, nxt + 1] = float(np.log(0.4))
    A[q[2::3, None], q[None, 0::3]] = float(np.log(0.4) - np.log(models))
    a0 = torch.full((1, Q), LZERO, device=dev)
    a0[0, 0::3] = float(-np.log(models))
    aE = torch.full((1, Q), LZERO, device=dev)
    aE[0, 2::3] = float(np.log(0.4))
    rng = np.random.default_rng(5)
    outp = torch.as_tensor(rng.normal(size=(1, T, Q)).astype(np.float32),
                           device=dev)
    return [outp, A[None], a0, aE,
            torch.full((1,), T, dtype=torch.int32, device=dev)]


def sweep(dev, rounds=3):
    from htk_tpu_torch.ops import fb_scans as fbs
    from htk_tpu_torch.ops._cuda import CudaKernel
    from htk_tpu_torch.utils.build import BUILD_DIR
    with open(fbs.KERNEL.source) as f:
        src = f.read()
    kernels = {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    for ll, sc in SWEEP:
        v = re.sub(r"constexpr int kLongList = \d+;",
                   f"constexpr int kLongList = {ll};", src)
        v = re.sub(r"constexpr int kStateCost = \d+;",
                   f"constexpr int kStateCost = {sc};", v)
        path = os.path.join(BUILD_DIR, f"fb_scans_L{ll}_C{sc}.cu")
        with open(path, "w") as f:
            f.write(v)
        k = CudaKernel("fb_scans", fbs._bind)
        k.source = path
        kernels[(ll, sc)] = k
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.build(), kernels.values()))
    ops = phone_loop(dev)
    ref = fbs.fb_scans_plain(*ops, xi=False)
    base = fbs.KERNEL
    scans = {key: [] for key in kernels}
    try:
        for _ in range(rounds):
            for key, k in kernels.items():
                fbs.KERNEL = k
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                got = fbs.fb_scans_cuda(*ops, xi=False, path="wide",
                                        events=ev)
                torch.cuda.synchronize(dev)
                if not torch.allclose(got[2], ref[2], rtol=1e-5, atol=0):
                    raise AssertionError(f"sweep {key}: logP differs")
                scans[key].append(ev[1].elapsed_time(ev[2]))
    finally:
        fbs.KERNEL = base
    for (ll, sc), ts in scans.items():
        emit(kind="sweep", long_list=ll, state_cost=sc, Q=ops[0].shape[2],
             T=ops[0].shape[1], scan=statistics.median(ts), samples=ts)


def compare(tree):
    """The narrow shapes on `tree` and on this checkout, in turns."""
    runs = {}
    for name, root in (("tree", tree), ("this", ROOT), ("this", ROOT),
                       ("tree", tree)):
        env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--narrow-only"], cwd=root, env=env,
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            raise RuntimeError(f"{root}: exit {out.returncode}\n"
                               f"{out.stderr[-3000:]}")
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                runs.setdefault((r["B"], r["T"], r["Q"]), {}).setdefault(
                    name, []).append(r)
    for (B, T, Q), by in runs.items():
        med = {n: {m: statistics.median(r[m] for r in rs)
                   for m in ("wall", "device")} for n, rs in by.items()}
        emit(kind="compare", B=B, T=T, Q=Q, tree=os.path.abspath(tree),
             tree_ms=med["tree"], this_ms=med["this"],
             ratio={m: med["this"][m] / med["tree"][m]
                    for m in ("wall", "device")},
             samples={n: [[r["wall"], r["device"]] for r in rs]
                      for n, rs in by.items()})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare", metavar="TREE")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--narrow-only", action="store_true",
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("fb_designs: no CUDA card")
    dev = torch.device("cuda")
    if a.narrow_only:
        narrow(dev)
        return
    print(card_line(), flush=True)
    if a.compare:
        compare(a.compare)
    else:
        narrow(dev)
    crossover(dev)
    if a.sweep:
        sweep(dev)


if __name__ == "__main__":
    main()
