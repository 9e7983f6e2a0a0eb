"""The port's demo twin (htk_tpu_torch/recipes/demo.py) on the CPU.

1. `python -m htk_tpu_torch.recipes.demo` runs the chain of
   recipes/demo/run_demo.sh through HResults on make_corpus.py's corpus
   and reports 100% word accuracy.
2. Stage by stage at tests/test_e2e.py's corpus size (6 utterances of 2
   words over aa/iy): each tool of the chain runs in the port's work
   directory, and htk_tpu's twin of it runs on a copy of that directory
   as it stood before the stage, so both read the port's previous-stage
   files. The host tools' outputs (HCompV, HLEd, HHEd CL/TI, TB, MU,
   HBuild, HResults' report) are byte-identical; HCopy's features have
   identical headers and data within the frontend's tolerance
   (_torch_compare); HERest's means and variances are held as
   tests/test_torch_herest.py holds them, its weights and transitions at
   rtol 5e-4 (on these speech features the two packages' float32
   occupancy sums part by up to 1.9e-4 of a transition probability, where
   test_torch_herest.py's synthetic system stays within 1e-4); HVite -z writes a byte-identical rec.mlf and lattices of
   the same structure with a= within 0.05. The chains themselves drift
   apart after HCopy (the features differ in the last bits), so they are
   compared stage by stage, not end to end.
"""

import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from htk_tpu.tools import hbuild as j_hbuild
from htk_tpu.tools import hcompv as j_hcompv
from htk_tpu.tools import hcopy as j_hcopy
from htk_tpu.tools import herest as j_herest
from htk_tpu.tools import hhed as j_hhed
from htk_tpu.tools import hled as j_hled
from htk_tpu.tools import hresults as j_hresults
from htk_tpu.tools import hvite as j_hvite
from htk_tpu_torch.io.htkfeat import read_htk_file
from htk_tpu_torch.recipes import demo

from _torch_compare import assert_features_close, assert_slf_close, one_torch_thread  # noqa: F401
from test_torch_herest import assert_mmf_close, params, read_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E2E_WORDS = {"A": ["aa"], "I": ["iy"]}
JAX_TOOL = {"HCopy": j_hcopy, "HCompV": j_hcompv, "HERest": j_herest,
            "HLEd": j_hled, "HHEd": j_hhed, "HBuild": j_hbuild,
            "HVite": j_hvite, "HResults": j_hresults}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


def test_demo_module_reaches_100_percent(tmp_path):
    env = dict(os.environ, HTK_TPU_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "htk_tpu_torch.recipes.demo",
         str(tmp_path / "w")], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert demo.PASS_LINE in out.stdout
    assert "DEMO PASSED" in out.stdout and "HMMIRest" in out.stdout
    assert "device cpu" in out.stdout
    with open(tmp_path / "w" / "results.txt") as f:
        assert demo.PASS_LINE in f.read()
    assert len(os.listdir(tmp_path / "w" / "lats")) == 10


def _snapshot(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _compare(label, rel, got, ref):
    """One output file of a stage: port's `got`, htk_tpu's `ref`."""
    if rel.endswith(".mfc"):
        assert got[:12] == ref[:12], rel
        assert_features_close(_feat(got), _feat(ref))
    elif label.startswith("HERest") and rel.endswith("hmmdefs"):
        return "mmf"
    elif label.startswith("HERest") and rel.endswith("stats"):
        return "stats"
    elif rel.endswith(".lat"):
        assert_slf_close(got.decode(), ref.decode())
    else:
        assert got == ref, f"{label}: {rel} differs"
    return None


def _feat(raw):
    with tempfile.NamedTemporaryFile(suffix=".mfc") as f:
        f.write(raw)
        f.flush()
        return read_htk_file(f.name).data


def _assert_models_close(got, ref):
    assert_mmf_close(got, ref, keys=("means", "variances"))
    g, r = params(got), params(ref)
    for k in ("weights", "transp"):
        np.testing.assert_allclose(g[k], r[k], rtol=5e-4, atol=1e-7,
                                   err_msg=k)


def test_demo_stagewise_parity(tmp_path, monkeypatch, capsys):
    port = tmp_path / "port"
    port.mkdir()
    monkeypatch.chdir(port)
    demo.make_corpus(n_train=6, seed=5, words=E2E_WORDS, n_words=2)
    for d in demo._DIRS + ("hmm1", "hmm2", "hmm3"):
        os.makedirs(d, exist_ok=True)
    checked = []
    for k, (label, tool, what) in enumerate(
            demo.stages(vowels=demo._vowels(E2E_WORDS))):
        if tool is None:
            what()
            continue
        ref_dir = tmp_path / f"ref{k}"
        shutil.copytree(port, ref_dir)
        before = _snapshot(port)
        capsys.readouterr()
        assert tool.main(list(what)) == 0, label
        port_out = capsys.readouterr().out
        monkeypatch.chdir(ref_dir)
        assert JAX_TOOL[label.split()[0]].main(list(what)) == 0, label
        ref_out = capsys.readouterr().out
        monkeypatch.chdir(port)
        after, ref_files = _snapshot(port), _snapshot(ref_dir)
        changed = sorted(r for r in after if before.get(r) != after[r])
        assert changed or label == "HResults", label
        assert sorted(r for r in ref_files if before.get(r) != ref_files[r]) \
            == changed, label
        for rel in changed:
            kind = _compare(label, rel, after[rel], ref_files[rel])
            if kind == "mmf":
                _assert_models_close(str(port / rel), str(ref_dir / rel))
            elif kind == "stats":
                (gn, go), (rn, ro) = (read_stats(str(p / rel))
                                      for p in (port, ref_dir))
                assert gn == rn
                np.testing.assert_allclose(go, ro, rtol=1e-3, atol=0.011)
        if label == "HResults":
            assert port_out == ref_out
            assert "WORD: %Corr=100.00, Acc=100.00" in port_out
        checked.append(label)
        shutil.rmtree(ref_dir)
    assert checked == [
        "HCopy", "HCompV", "HERest mono 1", "HERest mono 2",
        "HERest mono 3", "HLEd", "HHEd CL/TI", "HERest tri 1",
        "HERest tri 2", "HHEd TB", "HERest tied", "HHEd MU", "HERest mix",
        "HBuild", "HVite -z", "HResults"]
