"""Data-parallel training across the ranks of a torch.distributed group.

The PyTorch counterpart of `htk_tpu/parallel/mesh.py`: HTK's parallel
mode (`HERest -p N` jobs that exchange accumulator files) as one program.
Every rank runs the same pass over the same corpus; each global batch of
`batch_size * world` utterances is padded to a multiple of the ranks,
rank r forward-backwards its contiguous rows (the fb_scans kernel on the
card), and one `all_reduce` a batch sums the accumulators, as the
reference's `psum` over the mesh's data axis does. Accumulator addition
is exact and associative, so sharded training equals serial training up
to float32 summation order.

The process group is torch's: `torchrun` (`python -m
torch.distributed.run`) sets MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK
and LOCAL_RANK, the counterparts of JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES and JAX_PROCESS_ID; or `HTKTPU: COORDINATOR` names a
rendezvous (`tcp://host:port` or `file://path`) and WORLD_SIZE and RANK
give the rest. The backend follows the device: NCCL for a card, gloo for
the CPU.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..algo.trainer import Trainer, make_batches, pad_batch
from ..tools._common import default_device
from ..utils.errors import HError

# how long a rank waits for the others, at the rendezvous and at each
# collective, before it fails
JOIN_TIMEOUT = datetime.timedelta(seconds=300)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name, "").strip()
    return int(v) if v else None


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device=None,
                     timeout: datetime.timedelta = JOIN_TIMEOUT) -> bool:
    """Join this process to its ranks' group.

    `coordinator` is a rendezvous (`tcp://host:port`, `file://path`); by
    default torch's variables (MASTER_ADDR and MASTER_PORT, as torchrun
    sets them) name it. `num_processes` and `process_id` default to
    WORLD_SIZE and RANK. The backend is NCCL when `device` (by default
    the tools' `default_device()`) is a card, gloo otherwise. Returns
    True when a process group exists or was created, False on a plain
    single process with nothing configured. A rank that cannot join
    within `timeout` raises HError 1092."""
    if dist.is_initialized():
        return True
    if coordinator:
        if not coordinator.startswith(("tcp://", "file://")):
            HError(1092, "HTKTPU: COORDINATOR must be tcp://host:port or "
                         "file://path (got %s)", coordinator)
        init = coordinator
    elif os.environ.get("MASTER_ADDR"):
        init = "env://"
    else:
        return False
    world = num_processes if num_processes is not None else _env_int(
        "WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if world is None or rank is None or not 0 <= rank < world:
        HError(1092, "init_distributed: %s needs the world size and this "
                     "process's rank below it (WORLD_SIZE=%s, RANK=%s)",
               init, world, rank)
    device = torch.device(default_device() if device is None else device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {}
    if backend == "nccl":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        kw["device_id"] = device
    try:
        dist.init_process_group(backend, init_method=init, world_size=world,
                                rank=rank, timeout=timeout, **kw)
    except (RuntimeError, ValueError) as e:
        HError(1092, "init_distributed: rank %d of %d could not join %s "
                     "over %s: %s", rank, world, init, backend, e)
    return True


def make_mesh(n_devices: Optional[int] = None, axis: str = "data", *,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A one-axis mesh over every rank of the process group (which
    `init_distributed` made); `device_type` defaults to the tools'
    device's."""
    if not dist.is_initialized():
        HError(1093, "make_mesh: no process group (run under torchrun or "
                     "set HTKTPU: COORDINATOR, then init_distributed)")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        HError(1093, "make_mesh: %d devices asked for, the group has %d "
                     "ranks", n, world)
    return init_device_mesh(device_type or default_device().type, (n,),
                            mesh_dim_names=(axis,))


class ShardedTrainer(Trainer):
    """Trainer whose batch step shards utterances across a mesh axis."""

    def __init__(self, comp, mesh: DeviceMesh, axis: str = "data",
                 precision: str = "highest", prune=None, *, device):
        super().__init__(comp, precision=precision, prune=prune,
                         device=device)
        self.mesh = mesh
        self.axis = axis
        self.group = mesh.get_group(axis)
        self.n_dev = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    def _run_pass(self, utts, batch_size, params, total, beam):
        """One sharded pass; batch_size is per rank. Each global batch is
        padded to a multiple of the ranks (padding rows add nothing); rank
        r takes rows [r * B/n, (r + 1) * B/n). One all_reduce a batch
        carries the flattened accumulators and the batch's logPs, each
        rank's in its own rows and zeros elsewhere, so that every rank
        holds the summed accumulators and every logP (adding zeros is
        exact). Every rank makes the same collectives in the same order,
        so the -t retry ladder sees the same failures on each."""
        n, c = self.n_dev, self.comp
        sizes = [a.numel() for a in total]
        pending = []
        for batch in make_batches(utts, batch_size * n):
            bp = math.ceil(len(batch) / n) * n
            per = bp // n
            lo = self.rank * per
            arrs = pad_batch(batch, c.n_states, pad_to=bp)
            local = {k: torch.as_tensor(v[lo:lo + per], device=self.device)
                     for k, v in arrs.items()}
            logps, accs = self._fb(params, local, beam)
            lp = logps.new_zeros(bp)
            lp[lo:lo + per] = logps
            buf = torch.cat([a.reshape(-1) for a in accs] + [lp])
            dist.all_reduce(buf, group=self.group)
            parts = torch.split(buf, sizes + [bp])
            for a, p in zip(total, parts):
                a.add_(p.view_as(a))
            pending.append((batch, parts[-1]))
        flat = []
        for batch, lp in pending:
            flat.extend(zip(batch, lp.cpu().numpy()[:len(batch)]))
        return flat
