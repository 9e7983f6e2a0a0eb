"""Comparison helpers shared by the port's parity tests.

The two packages' float32 matmuls round differently, so files that carry
scores from a device computation (SLF lattices' acoustic scores, HCopy's
feature data) are compared field by field with a stated tolerance, and
everything else byte for byte.
"""

import importlib
import os
import shutil

import numpy as np
import pytest
import torch

# write_slf prints a= with 2 decimals: the two packages' OutP can differ
# in that last printed digit, or across a rounding edge by one more
SLF_A_ATOL = 0.05
# the frontend: max |diff| and mean |diff| over a file's features
FE_MAX = 1e-3
FE_MEAN = 2e-5
# kinds with a scale of their own (MELSPEC's linear filterbank magnitudes,
# the liftered LPC cepstra of PLP and LPCEPSTRA): max and mean |diff| over
# the largest |reference value|. The reference's own float32 PLP cepstra
# part from a float64 evaluation by 1.7e-5 of their largest value
# (tests/_frontend_stages.py), and the port's float64 result sits there
FE_REL_MAX = 5e-5
FE_REL_MEAN = 2e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while a module's tests run: the suite runs in
    several worker processes at once, and each worker's default of one
    OpenMP thread a core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(line):
    return dict(f.split("=", 1) for f in line.split())


def assert_slf_close(got: str, ref: str, atol: float = SLF_A_ATOL):
    """Two SLF texts: identical structure (header, nodes, times, words,
    arc endpoints, l=), acoustic scores a= within `atol`."""
    g, r = got.splitlines(), ref.splitlines()
    assert len(g) == len(r), (len(g), len(r))
    for lg, lr in zip(g, r):
        if lg == lr:
            continue
        fg, fr = _fields(lg), _fields(lr)
        assert fg.keys() == fr.keys(), (lg, lr)
        for k in fg:
            if k == "a":
                assert abs(float(fg[k]) - float(fr[k])) <= atol, (lg, lr)
            else:
                assert fg[k] == fr[k], (lg, lr)


def assert_features_close(got: np.ndarray, ref: np.ndarray,
                          max_tol: float = FE_MAX, mean_tol: float = FE_MEAN):
    assert got.shape == ref.shape, (got.shape, ref.shape)
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert d.max() <= max_tol, f"max |diff| {d.max()}"
    assert d.mean() <= mean_tol, f"mean |diff| {d.mean()}"


def assert_scaled_close(got: np.ndarray, ref: np.ndarray,
                        max_tol: float = FE_REL_MAX,
                        mean_tol: float = FE_REL_MEAN):
    """Features held relative to the largest |ref| value."""
    s = float(np.abs(np.asarray(ref, np.float64)).max())
    assert_features_close(np.asarray(got, np.float64) / s,
                          np.asarray(ref, np.float64) / s, max_tol, mean_tol)


def _snapshot(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def run_both(tmp_path, monkeypatch, capsys, tool, argv, inputs,
             entry="main"):
    """Run `tool` of both packages (its function `entry`) on copies of the
    `inputs` directory; returns ({file: bytes} written by the port, the
    same for htk_tpu, (port stdout, htk_tpu stdout), (port stderr,
    htk_tpu stderr), (port rc, htk_tpu rc))."""
    out = []
    for pkg in ("htk_tpu_torch", "htk_tpu"):
        d = tmp_path / pkg
        shutil.copytree(inputs, d)
        before = _snapshot(d)
        monkeypatch.chdir(d)
        capsys.readouterr()
        mod = importlib.import_module(f"{pkg}.tools.{tool}")
        rc = getattr(mod, entry)(list(argv))
        cap = capsys.readouterr()
        after = _snapshot(d)
        out.append(({r: b for r, b in after.items() if before.get(r) != b},
                    cap.out, cap.err, rc))
    (fp, op, ep, rp), (fj, oj, ej, rj) = out
    return fp, fj, (op, oj), (ep, ej), (rp, rj)


def assert_same(tmp_path, monkeypatch, capsys, tool, argv, inputs,
                stdout=True, entry="main"):
    """Both packages' `tool` exit 0 and write the same files, byte for
    byte (and print the same stdout, unless `stdout` is False)."""
    fp, fj, (op, oj), _err, (rp, rj) = run_both(
        tmp_path, monkeypatch, capsys, tool, argv, inputs, entry)
    assert rp == rj == 0
    assert sorted(fp) == sorted(fj) and fp, (sorted(fp), sorted(fj))
    for rel in fp:
        assert fp[rel] == fj[rel], rel
    if stdout:
        assert op == oj
    return fp
