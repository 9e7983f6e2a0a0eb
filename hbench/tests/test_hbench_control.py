"""The control on the card: the program's TF32 OutP path in place of the
configuration's FP32 comes out not correct. A cell at its own widths with
a short pool and window; skips where there is no CUDA card."""

import time

import pytest
import torch

from hbench.core import spec
from hbench.run import run_cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_the_control_fails_the_check(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = spec.cell(name)
    c.workload = dict(c.workload, pool=4 * c.workload["batch"])
    dev = torch.device("cuda", 0)
    sound = run_cell(c, 2 ** 31 + 7, 1.0, False, dev,
                     t_process=time.perf_counter())
    control = run_cell(c, 2 ** 31 + 7, 1.0, False, dev, control=True,
                       t_process=time.perf_counter())
    assert sound["correct"], sound["checks"]
    assert not control["correct"], control["checks"]
