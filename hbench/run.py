"""Run one cell of htk_tpu_torch's benchmark once and print its result.

    python3 hbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control 1]

From the root of a checkout that holds BENCHMARK.json, hbench/ and
htk_tpu_torch/. The run builds the cell's system and traffic from the
seed, warms up every shape the traffic uses (set-up), measures for
`--seconds` seconds (with --trace 1 an untraced window for the per-layer
metrics read by the host's clock, then a traced one), checks a sample of what the window produced against
the plain reference in hbench/reference/, and prints one JSON line as the
last line of standard output: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics; with --trace 1 its per-layer metrics from
a torch.profiler trace of the window), `device`, with --trace 1
`breakdown`, and last `checks` (each number compared with its limit, also
the last lines of standard error). It runs on the first CUDA card and
exits 2 without printing a result where there is none. `--control 1`
runs the program's own lower-precision path (TF32 OutP) in place of the
configuration's: the control that `correct` has to fail.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "hbench", "_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "htk_tpu")


def forbidden_modules():
    """Top-level names in sys.modules that the run must not load, each
    compared whole (htk_tpu_torch is not htk_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             control: bool = False, t_process: float = T_PROCESS) -> dict:
    """Set up, measure and check one cell on `device`; the result line as
    a dict (its `checks` key last)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from hbench.core import spec
    from hbench.core import trace as trace_mod

    cuda = device.type == "cuda"
    readers = spec.readers(cell.per_layer) if trace else {}
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    job = spec.driver(cell.workload["driver"]).Job(cell, seed, device,
                                                   control)
    job.warm_up()
    # set-up's objects move to the collector's permanent generation, so
    # that collections in the window do not walk them again
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_process
    tr = host_ctx = None
    if trace and any(m["source"] == "host_clock" for m in cell.per_layer):
        # the host clock reads an untraced window: the profiler changes
        # how fast the host side runs
        job.window(seconds)
        host_ctx = job.context()
    if trace:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            with record_function(trace_mod.WINDOW):
                job.window(seconds)
            t_stop = time.perf_counter()
        t_read = time.perf_counter()
        tr = trace_mod.read(prof)
        del prof
        print(f"trace: profiler stop {t_read - t_stop:.1f} s, read "
              f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
    else:
        job.window(seconds)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        ctx = dict(job.context(), trace=tr)
        values = {m["name"]: readers[m["name"]](
            host_ctx if m["source"] == "host_clock" else ctx)
            for m in cell.per_layer}
    else:
        values = dict(job.end_to_end(), setup_s=setup_s)
        values = {m["name"]: values[m["name"]] for m in cell.end_to_end}
    metrics = {k: {"value": float(v), "unit": units[k]}
               for k, v in values.items() if v is not None}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": False, "attempted": job.n_requests,
           "failed": job.n_failed, "metrics": metrics, "device": dev,
           "setup_phases": job.setup_phases, "windows": job.window_log}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                            "idle_gaps": [list(x) for x in tr.idle_gaps]}
    job.release()
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = job.check()
    job.window_log.append(f"check: {job.checked} requests, "
                          f"{time.perf_counter() - t_check:.1f} s")
    out["correct"] = bool(job.n_failed == 0 and job.checked > 0
                          and all(v <= lim for _, v, lim in checks))
    out["checks"] = {k: {"value": float(v), "limit": lim}
                     for k, v, lim in checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)
    import torch

    from hbench.core import spec

    cell = spec.cell(args.workload, ROOT)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < cell.chips:
        print(f"hbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"found {n}; no result", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), bool(args.control))
    bad = forbidden_modules()
    if bad:
        print(f"hbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    for name, sec in out.pop("setup_phases"):
        print(f"setup {name}: {sec:.3f} s", file=sys.stderr)
    for line in out.pop("windows"):
        print(line, file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
