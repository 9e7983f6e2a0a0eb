"""Rank bodies for the port's multi-rank tests.

`htk_tpu_torch.parallel.dryrun.spawn_ranks` runs each of these in fresh
processes joined as one gloo group on the CPU; they import torch and the
port only (no JAX), read their inputs from a file the test wrote and
rank 0 writes the results back. A rank's collectives wait at most
RANK_TIMEOUT for the others, inside the launcher's own timeout.
"""

import datetime
import functools
import pickle

import numpy as np
import torch
import torch.distributed as dist

from htk_tpu_torch.parallel.mesh import (ShardedTrainer, init_distributed,
                                         make_mesh)
from htk_tpu_torch.parallel.timeshard import (fb_time_sharded,
                                              fb_time_sharded_batch,
                                              gather_blocks)

RANK_TIMEOUT = datetime.timedelta(seconds=30)
SPAWN_TIMEOUT = 50.0  # seconds for a whole group, start-up included


def _join(init):
    init_distributed(coordinator=init, timeout=RANK_TIMEOUT)


def sharded_accs(init, data, out, batch_size):
    """ShardedTrainer over the pickled (comp, utts) in `data`; rank 0
    saves the accumulators to `out` (npz)."""
    _join(init)
    try:
        with open(data, "rb") as f:
            comp, utts = pickle.load(f)
        accs = ShardedTrainer(comp, make_mesh(), device="cpu").accumulate(
            utts, batch_size=batch_size)
        if dist.get_rank() == 0:
            np.savez(out, **{k: v.numpy() for k, v in accs._asdict().items()})
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _whole(res, mesh, **axes):
    al, be, lp, xi = res
    return [gather_blocks(al, mesh, **axes).numpy(),
            gather_blocks(be, mesh, **axes).numpy(), lp.numpy(), xi.numpy()]


def _one(outp, ops, mesh):
    return fb_time_sharded(outp, *ops, mesh)


def _two(outp, ops, mesh):
    return fb_time_sharded_batch(outp, *ops, mesh)


def timeshard_cases(init, data, out):
    """Every case of the npz `data` through the time-sharded FB on this
    group: `one_<name>` (outp, logA, a0, aE) with fb_time_sharded over a
    one-axis mesh of every rank, `two_<name>` with fb_time_sharded_batch
    over a (2, world/2) mesh; rank 0 saves alphas, betas, logP and xi
    gathered whole, and whether an indivisible T raised ValueError."""
    from torch.distributed.device_mesh import init_device_mesh

    _join(init)
    try:
        z = np.load(data)
        n = dist.get_world_size()
        mesh = make_mesh(axis="t")
        res = {}
        for key in sorted({k.split(":")[0] for k in z.files}):
            ops = [z[f"{key}:{a}"] for a in ("outp", "logA", "a0", "aE")]
            outp = torch.as_tensor(ops[0])
            if key.startswith("one_"):
                run = functools.partial(_one, ops=ops[1:], mesh=mesh)
                got = _whole(run(outp), mesh)
                cuts = [outp[1:]]  # T - 1 frames
            else:
                mesh2 = init_device_mesh("cpu", (2, n // 2),
                                         mesh_dim_names=("d", "t"))
                run = functools.partial(_two, ops=ops[1:], mesh=mesh2)
                got = _whole(run(outp), mesh2, dp_axis="d")
                cuts = [outp[:, 1:], outp[1:]]  # T - 1 frames, B - 1 rows
            for name, a in zip(("alphas", "betas", "logp", "xi"), got):
                res[f"{key}:{name}"] = a
            raised = []
            for x in cuts:
                try:
                    run(x)
                    raised.append(False)
                except ValueError:
                    raised.append(True)
            res[f"{key}:raised"] = np.array(raised)
        if dist.get_rank() == 0:
            np.savez(out, **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def lonely_rank(init, timeout_s):
    """Join a group whose other ranks never come: HError 1092 after
    `timeout_s`."""
    init_distributed(coordinator=init,
                     timeout=datetime.timedelta(seconds=timeout_s))
