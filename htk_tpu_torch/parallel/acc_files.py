"""File-based accumulator exchange (HERest -p parity mode).

Mirrors `HTKLib/HTrain.c : DumpAccs()/LoadAccs()`: a shard job writes its
summed Accumulators to disk; a combine job loads and adds them before
updating (SURVEY.md §5.3).

The PyTorch counterpart of `htk_tpu/parallel/acc_files.py`, in the same
format: numpy .npz with the Accumulator fields under the same names plus
a `__version__` entry, so an .acc file written by either package loads in
the other. [LC] Not byte-compatible with HTK's binary .acc files; the
role and algebra are identical.
"""

from __future__ import annotations

import os
import tempfile
from typing import Sequence

import numpy as np
import torch

from ..algo.fb import Accumulators
from ..utils.errors import HError

_FIELDS = Accumulators._fields


def dump_accs(accs: Accumulators, path: str) -> None:
    # atomic (temp + fsync + rename): a crashed shard must either leave
    # a complete .acc to combine or nothing — never a truncated file
    # that poisons the -p 0 combine (SURVEY §5.3 idempotent recovery)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(
                f, __version__=1,
                **{k: getattr(accs, k).cpu().numpy() for k in _FIELDS})
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_accs(path: str) -> Accumulators:
    """An .acc file as Accumulators of CPU tensors."""
    try:
        z = np.load(path)
    except OSError as e:
        HError(7110, "LoadAccs: cannot open accumulator file %s (%s)", path, e)
    missing = [f for f in _FIELDS if f not in z]
    if missing:
        HError(7111, "LoadAccs: %s missing fields %s", path, missing)
    return Accumulators(**{f: torch.as_tensor(z[f]) for f in _FIELDS})


def sum_accs(accs_list: Sequence[Accumulators]) -> Accumulators:
    out = accs_list[0]
    for a in accs_list[1:]:
        if a.occ.shape != out.occ.shape or a.tr.shape != out.tr.shape:
            HError(7112, "sum_accs: accumulator shape mismatch (different "
                         "model?)")
        out = Accumulators(*[x + y for x, y in zip(out, a)])
    return out
