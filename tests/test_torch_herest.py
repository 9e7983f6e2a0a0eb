"""Port HERest (htk_tpu_torch) against htk_tpu's, on the CPU.

A tiny system (6 words, 8 phones, 20 tied 2-mixture states, 39 dims, 6
utterances of 81-144 frames, phone-level train.mlf) is written with the
port's generator (htk_tpu_torch/synth.py), and both packages' HERest train
it from the same files. The output MMFs agree in weights and transitions
within rtol 1e-4, and in means and variances within rtol 1e-4 plus an atol
of 1e-3 of each array's scale; the average log prob per frame within 1e-5
relative. Why the atol: XLA's and torch's float32 matmuls (OutP, the
moment sums) round differently in most entries, alphas and betas of
magnitude ~1e4 carry that into every occupancy, and a variance, E[x^2]
minus the squared mean, cancels most; the reference's own two trainer
paths are held at rtol/atol 5e-4 (test_composite_device.py).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from htk_tpu.io.mmf import save_mmf as j_save_mmf
from htk_tpu.tools import herest as jax_herest
from htk_tpu_torch.io.mmf import load_mmf
from htk_tpu_torch.models.hmmset import compile_hmmset
from htk_tpu_torch.synth import write_system
from htk_tpu_torch.tools import herest as torch_herest

from _torch_compare import one_torch_thread  # noqa: F401
from test_discrete import discrete_set

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_COMPOSITE = "HTKTPU: DEVICECOMPOSITE = F\n"
# per mode: config lines and options, the same for both packages; -t:
# every utterance fails at 0.2 and passes at 0.5
MODES = {
    "default": ("", ["-s", "stats"]),
    "host": (HOST_COMPOSITE, ["-u", "mv"]),
    "ladder": ("", ["-t", "0.2", "0.3", "3", "-v", "0.2"]),
}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


def _train(run, s, out, extra_cfg="", args=(), mmf=None):
    """One HERest iteration into `out` (a -s file there too); returns (MMF
    path, logP/frame)."""
    os.makedirs(out, exist_ok=True)
    args = [os.path.join(out, a) if a == "stats" else a for a in args]
    cfg = os.path.join(out, "herest.cfg")
    metrics = os.path.join(out, "metrics.jsonl")
    with open(cfg, "w") as f:
        f.write(f"HTKTPU: METRICS = {metrics}\n{extra_cfg}")
    rc = run(["-C", cfg, "-H", mmf or s.hmmdefs, "-M", out, "-S",
              s.train_scp, "-I", s.train_mlf, *args, s.hmmlist])
    assert rc == 0
    with open(metrics) as f:
        rec = json.loads(f.read().splitlines()[-1])
    return os.path.join(out, "hmmdefs"), rec["logp_per_frame"]


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    root = tmp_path_factory.mktemp("herest_sys")
    s = write_system(str(root), n_words=6, n_phones=8, n_tied=20, n_mix=2,
                     dim=39, n_utts=6, min_frames=60, max_frames=150,
                     fanout=3, seed=1, binary_mmf=False)
    jax_runs = {mode: _train(jax_herest.run, s, str(root / f"jax_{mode}"),
                             cfg, args)
                for mode, (cfg, args) in MODES.items()}
    jax_dump = root / "jax_p1"
    assert jax_herest.run(["-H", s.hmmdefs, "-M", str(jax_dump), "-p", "1",
                           "-S", s.train_scp, "-I", s.train_mlf,
                           s.hmmlist]) == 0
    return s, root, jax_runs, str(jax_dump / "HER1.acc")


def params(path):
    c = compile_hmmset(load_mmf([path]))
    w = np.where(c.state_mix >= 0, np.exp(c.state_logw), 0.0)
    return dict(means=c.means, variances=c.variances, weights=w,
                transp=np.exp(np.maximum(c.log_transp, -700.0)))


def assert_mmf_close(got, ref, keys=("weights", "transp", "means",
                                     "variances")):
    g, r = params(got), params(ref)
    for k in keys:
        # means and variances: an atol of 1e-3 of the array's scale (see
        # the module docstring)
        atol = (1e-7 if k in ("weights", "transp")
                else 1e-3 * float(np.abs(r[k]).max()))
        np.testing.assert_allclose(g[k], r[k], rtol=1e-4, atol=atol,
                                   err_msg=k)


def read_stats(path):
    """A -s stats file as (names and utterance counts, occupancies)."""
    with open(path) as f:
        rows = [line.split() for line in f]
    return ([r[:3] for r in rows],
            np.array([float(x) for r in rows for x in r[3:]]))


@pytest.mark.parametrize("mode", list(MODES))
def test_herest_matches_jax(system, tmp_path, mode, capsys):
    s, _root, jax_runs, _acc = system
    cfg, args = MODES[mode]
    mmf, lp = _train(torch_herest.run, s, str(tmp_path), cfg,
                     args=("-T", "1", *args))
    ref_mmf, ref_lp = jax_runs[mode]
    assert lp == pytest.approx(ref_lp, rel=1e-5)
    assert_mmf_close(mmf, ref_mmf)
    out = capsys.readouterr().out
    assert "device cpu" in out
    if mode == "default":
        (names, occ), (ref_names, ref_occ) = [
            read_stats(os.path.join(os.path.dirname(p), "stats"))
            for p in (mmf, ref_mmf)]
        assert names == ref_names
        # printed to two decimals: 0.01 apart at a rounding edge
        np.testing.assert_allclose(occ, ref_occ, rtol=1e-3, atol=0.011)
    if mode == "host":  # -u mv: weights and transitions as they were
        assert_mmf_close(mmf, s.hmmdefs, keys=("weights", "transp"))
    if mode == "ladder":
        assert "retrying 6 utterance(s) at beam 0.5" in out
        # the beam binds at 0.5: less likely than exact
        assert lp < jax_runs["default"][1]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_dump_and_combine_equal_one_pass(system, tmp_path):
    s, _root, _jax_runs, _acc = system
    one, _lp = _train(torch_herest.run, s, str(tmp_path / "one"))
    d = str(tmp_path / "p")
    assert torch_herest.run(["-H", s.hmmdefs, "-M", d, "-p", "1", "-S",
                             s.train_scp, "-I", s.train_mlf,
                             s.hmmlist]) == 0
    acc = os.path.join(d, "HER1.acc")
    assert torch_herest.run(["-H", s.hmmdefs, "-M", d, "-p", "0", s.hmmlist,
                             acc]) == 0
    assert _read(os.path.join(d, "hmmdefs")) == _read(one)


def test_acc_files_cross_load(system, tmp_path):
    """An .acc file dumped by either package combines in the other; a
    combine reestimates with the same numpy code in both, so the output
    MMF is byte-identical to the dumping package's own."""
    s, _root, _jax_runs, jax_acc = system
    d = str(tmp_path / "from_jax")
    assert torch_herest.run(["-H", s.hmmdefs, "-M", d, "-p", "0", s.hmmlist,
                             jax_acc]) == 0
    assert jax_herest.run(["-H", s.hmmdefs, "-M", str(tmp_path / "jax0"),
                           "-p", "0", s.hmmlist, jax_acc]) == 0
    assert _read(os.path.join(d, "hmmdefs")) == _read(
        str(tmp_path / "jax0" / "hmmdefs"))

    p = str(tmp_path / "torch_p1")
    assert torch_herest.run(["-H", s.hmmdefs, "-M", p, "-p", "1", "-S",
                             s.train_scp, "-I", s.train_mlf,
                             s.hmmlist]) == 0
    d2 = str(tmp_path / "from_torch")
    assert jax_herest.run(["-H", s.hmmdefs, "-M", d2, "-p", "0", s.hmmlist,
                           os.path.join(p, "HER1.acc")]) == 0
    assert torch_herest.run(["-H", s.hmmdefs, "-M", p, "-p", "0", s.hmmlist,
                             os.path.join(p, "HER1.acc")]) == 0
    assert _read(os.path.join(d2, "hmmdefs")) == _read(
        os.path.join(p, "hmmdefs"))


def test_logp_rises_over_two_iterations(system, tmp_path):
    s, _root, _jax_runs, _acc = system
    mmf1, lp1 = _train(torch_herest.run, s, str(tmp_path / "it1"))
    _mmf2, lp2 = _train(torch_herest.run, s, str(tmp_path / "it2"),
                        mmf=mmf1)
    assert lp2 > lp1


def _fullc_mmf(s, path):
    hs = load_mmf([s.hmmdefs])
    hs.cov_kind = "FULLC"
    for st in hs.macros["s"].values():
        for mp in st.streams[0].mixes:
            mp.var = np.diag(1.0 / mp.var).astype(np.float32)
            mp.cov_kind = "FULLC"
            mp.fix_gconst()
    from htk_tpu_torch.io.mmf import save_mmf

    save_mmf(hs, path)


@pytest.mark.parametrize("case", ["-r", "-a", "-J", "-K", "-h", "FULLC",
                                  "DISCRETE", "MAPTAU"])
def test_unported_options_raise_numbered_error(system, tmp_path, case,
                                               capsys):
    """-r, FULLC and DISCRETE training, refused with HError 2390 until
    their modules were ported, now run as the reference's: -r over
    train.scp paired on alternating lines (the second file of a pair, a
    different utterance, clipped to the first's frames: HRError 7327),
    the FULLC set (-v 1: a diagonal loading that keeps 39 x 39
    covariances from a few frames invertible; tests/test_torch_fullcov.py's
    tolerances), and a DISCRETE set on tests/test_torch_discrete.py's
    codeword files (tables within one DPROB step). -a, -J, -K, -h and
    HMAP: MAPTAU, refused until the adaptation module was ported, now run
    as the reference's: -a, -J and -h alone change nothing (no TMFs to
    apply), -K writes a global MLLRMEAN TMF (within
    tests/test_torch_sat.py's tolerances) and MAPTAU a MAP-updated MMF;
    the MMFs within this file's tolerances."""
    s, _root, _jax_runs, _acc = system
    mmf, hmmlist, opts = s.hmmdefs, s.hmmlist, []
    scp, mlf = s.train_scp, s.train_mlf
    if case in ("-r", "-a"):
        opts = [case]
    elif case in ("-J", "-K", "-h"):
        opts = [case, "OUT/xf" if case == "-K" else str(tmp_path)]
    elif case == "FULLC":
        mmf = str(tmp_path / "fullc")
        _fullc_mmf(s, mmf)
        opts = ["-v", "1"]
    elif case == "DISCRETE":
        from test_torch_discrete import write_discrete_corpus

        write_discrete_corpus(str(tmp_path))
        mmf, hmmlist = str(tmp_path / "discrete"), str(tmp_path / "list")
        scp, mlf = str(tmp_path / "train.scp"), str(tmp_path / "phones.mlf")
        j_save_mmf(discrete_set(), mmf)
    else:
        cfg = str(tmp_path / "map.cfg")
        with open(cfg, "w") as f:
            f.write("HMAP: MAPTAU = 10\n")
        opts = ["-C", cfg]
    from test_torch_sat import assert_tmf_close

    outs = []
    for run, tag in ((torch_herest.run, "p"), (jax_herest.run, "j")):
        out = str(tmp_path / tag)
        os.makedirs(out)
        assert run([o.replace("OUT", out) for o in opts]
                   + ["-H", mmf, "-M", out, "-S", scp, "-I", mlf,
                      hmmlist]) == 0
        outs.append(out)
    got, ref = (os.path.join(o, os.path.basename(mmf)) for o in outs)
    if case == "-K":
        assert_tmf_close(*(os.path.join(o, "xf", "global.tmf")
                           for o in outs))
    elif case == "FULLC":
        from test_torch_fullcov import assert_fullc_close

        assert_fullc_close(got, ref)
    elif case == "DISCRETE":
        from test_torch_discrete import DPROB_STEP

        g, r = (compile_hmmset(load_mmf([p])) for p in (got, ref))
        np.testing.assert_allclose(g.dprob_table, r.dprob_table, rtol=0,
                                   atol=1.01 * DPROB_STEP)
        assert_mmf_close(got, ref, keys=("transp",))
    else:
        assert_mmf_close(got, ref)
    if case == "-r":
        # two of the three pairs differ in length, in each package
        assert capsys.readouterr().err.count("[-7327]") == 4


@pytest.mark.parametrize("tool", ["herest", "hvite"])
def test_no_card_and_no_cpu_request_exits_numbered(system, tool):
    """With no card visible and HTK_TPU_TORCH_DEVICE unset, a tool stops
    with HError 1090 instead of running on the CPU."""
    s, _root, _jax_runs, _acc = system
    env = {k: v for k, v in os.environ.items() if k != "HTK_TPU_TORCH_DEVICE"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    if tool == "herest":
        args = ["-H", s.hmmdefs, "-M", s.root, "-S", s.train_scp, "-I",
                s.train_mlf, s.hmmlist]
    else:
        args = ["-w", s.wdnet, "-H", s.hmmdefs, "-i",
                os.path.join(s.root, "x.mlf"), "-S", s.scp, s.dict,
                s.hmmlist]
    out = subprocess.run(
        [sys.executable, "-m", f"htk_tpu_torch.tools.{tool}", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "[+1090]" in out.stderr, out.stderr
    assert not os.path.exists(os.path.join(s.root, "x.mlf"))
