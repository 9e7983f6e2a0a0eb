"""The full recipe of recipes/full/run_full.sh, every stage, on
htk_tpu_torch.

The twin of `recipes/full/run_full.sh` (which drives the console scripts
bound to htk_tpu), as recipes/demo.py is run_demo.sh's. It writes the
corpus of `recipes/full/make_corpus.py` (seed 33; at the default size two
training speakers with 24 utterances each and two unseen speakers with 8
enrollment and 12 test utterances each: the same files, byte for byte)
with the port's own synthesizer (recipes/speech.py), then runs every tool
of the chain in-process through its `main`, with run_full.sh's arguments:

  HCopy -> HCompV -> HERest x3 (monophones)
  HLEd WB/TC -> HHEd CL/TI -> HERest x2
  HHEd RO/QS/TB/ST/AU/CO tree tying (unseen-triphone synthesis)
  -> HERest x2 -> HHEd MU -> HERest x2
  HBuild -> HVite (held-out test set)                 [stage: tied+mix]
  HVite -z lattices, HVite -a -z numerator lattices
  -> HMMIRest -> HVite                                [stage: MMI]
  HLEd -> HERest -K per-speaker CMLLR (BLOCKS 3) on the enrollment set
  -> HVite -J -h                                      [stage: adapted]
  LBuild -n 3 -> HDecode (trigram)                    [stage: HDecode]

Each stage's HResults WORD line goes into results.md (stage | %Corr |
%Acc), which is scored by the rule of recipes/full/check_results.py:
a stage fails when its %Corr or %Acc falls more than TOL = 3.0 below
results_expected.md's (EXPECTED here, copied from that file). The device
work runs on `tools/_common.default_device()`: the CUDA card, or the CPU
when HTK_TPU_TORCH_DEVICE=cpu asks for it.

Usage: python -m htk_tpu_torch.recipes.full [workdir]
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..io.mmf import load_mmf, save_mmf
from ..models.proto import clone_proto, make_proto
from ..tools import (hbuild, hcompv, hcopy, hdecode, herest, hhed, hled,
                     hmmirest, hresults, hvite, lbuild)
from ..tools._common import default_device
from .speech import synth_words, write_wav

WORDS = {
    "ONE": ["aa", "iy"],
    "TWO": ["iy", "uw"],
    "THREE": ["uw", "aa", "iy"],
    "FOUR": ["eh", "aa"],
    "FIVE": ["iy", "eh", "uw"],
    "SIX": ["uw", "eh"],
    "SEVEN": ["aa", "uw", "eh"],
    "EIGHT": ["eh", "iy", "aa", "iy"],
}
PHONES = ["aa", "eh", "iy", "uw"]
# name: (formant scale, f0 start, f0 end); the test speakers' vocal
# tracts lie outside the training speakers' range
SPEAKERS = {
    "spkA": (0.96, 180.0, 140.0),
    "spkB": (1.00, 125.0, 90.0),
    "spkC": (1.065, 110.0, 85.0),
    "spkD": (1.11, 95.0, 75.0),
}
TRAIN_SPK = ("spkA", "spkB")

# recipes/full/results_expected.md and check_results.py's band
EXPECTED = {"tied+mix": (97.35, 97.35), "MMI": (95.58, 95.58),
            "adapted": (100.00, 100.00), "HDecode": (99.12, 99.12)}
TOL = 3.0

SPK_MASK = "%%%%_*"


def make_corpus(n_train: int = 24, n_adapt: int = 8, n_test: int = 12,
                seed: int = 33) -> float:
    """Write make_corpus.py's corpus into the current directory (its
    N_TRAIN, N_ADAPT and N_TEST are `n_train`, `n_adapt`, `n_test`);
    returns the seconds of audio."""
    rng = np.random.default_rng(seed)
    wnames = list(WORDS)
    scps: Dict[str, List[str]] = {"train": [], "adapt": [], "test": []}
    copy_lines = []
    words_mlf: Dict[str, List[str]] = {"train": [], "adapt": [], "test": []}
    phones_mlf: Dict[str, List[str]] = {"train": [], "adapt": []}
    secs = 0.0
    for spk, (fsc, f0s, f0e) in SPEAKERS.items():
        os.makedirs(spk, exist_ok=True)
        sets = ({"train": n_train} if spk in TRAIN_SPK
                else {"adapt": n_adapt, "test": n_test})
        for part, n in sets.items():
            for i in range(n):
                k = int(rng.integers(3, 7))
                ws = [wnames[int(x)]
                      for x in rng.integers(0, len(wnames), size=k)]
                phs = ["sil"]
                for w in ws:
                    phs += WORDS[w] + ["sil"]
                base = f"{spk}/{spk}_{part}{i}"
                lab = f"{spk}_{part}{i}.lab"
                x = synth_words(phs, rng, formant_scale=fsc, f0_start=f0s,
                                f0_end=f0e)
                secs += len(x) / 16000.0
                write_wav(base + ".wav", x)
                copy_lines.append(f"{base}.wav {base}.mfc")
                scps[part].append(f"{base}.mfc")
                words_mlf[part] += [f'"*/{lab}"'] + ws + ["."]
                if part in phones_mlf:
                    phones_mlf[part] += [f'"*/{lab}"'] + phs + ["."]

    def put(path, text):
        with open(path, "w") as f:
            f.write(text)

    put("copy.scp", "\n".join(copy_lines) + "\n")
    for part, lines in scps.items():
        put(part + ".scp", "\n".join(lines) + "\n")
    for part in ("train", "adapt", "test"):
        put(f"words_{part}.mlf",
            "#!MLF!#\n" + "\n".join(words_mlf[part]) + "\n")
    put("phones.mlf", "#!MLF!#\n" + "\n".join(phones_mlf["train"]) + "\n")
    put("phones_adapt.mlf",
        "#!MLF!#\n" + "\n".join(phones_mlf["adapt"]) + "\n")
    put("dict", "".join(f"{w}  {' '.join(WORDS[w])}\n" for w in sorted(WORDS))
        + "SIL []  sil\n")
    put("dict_hd", "".join(f"{w}  {' '.join(WORDS[w])}\n"
                           f"{w}  {' '.join(WORDS[w])} sil\n"
                           for w in sorted(WORDS))
        + "<s> []  sil\n</s> []  sil\n")
    put("wlist", "\n".join(sorted(WORDS)) + "\nSIL\n")
    put("monophones", "\n".join(PHONES + ["sil"]) + "\n")
    save_mmf(make_proto(nstates=5, dim=39, parm_kind="MFCC_E_D_A"), "proto")
    return secs


# -- run_full.sh's inline steps ----------------------------------------------


def _write(path: str, text: str) -> Callable[[], None]:
    def step():
        with open(path, "w") as f:
            f.write(text)
    return step


def clone_monophones() -> None:
    """run_full.sh:68-75: the flat-start proto cloned per monophone, with
    HCompV's variance floor."""
    cl = clone_proto(load_mmf("hmm0/proto"), "proto", PHONES + ["sil"])
    cl.macros["v"]["varFloor1"] = \
        load_mmf("hmm0/vFloors").macros["v"]["varFloor1"]
    save_mmf(cl, "hmm0/hmmdefs")


def write_triphone_lists() -> None:
    """run_full.sh:87-109: tri.mlf's labels as `triphones`, and the full
    word-internal context inventory over the vowels (plus sil) as
    `alltri`, which AU retargets the tied trees onto."""
    names = set()
    with open("tri.mlf") as f:
        for ln in f:
            ln = ln.strip()
            if ln and not ln.startswith(("#", '"', ".")):
                names.add(ln)
    with open("triphones", "w") as f:
        f.write("\n".join(sorted(names)) + "\n")
    full = set(names)
    for p in PHONES:
        full.add(p)
        for lc in PHONES:
            full.add(f"{lc}-{p}")
            for rc in PHONES:
                full.add(f"{lc}-{p}+{rc}")
        for rc in PHONES:
            full.add(f"{p}+{rc}")
    with open("alltri", "w") as f:
        f.write("\n".join(sorted(full | {"sil"})) + "\n")


def _tri_hed() -> str:
    """mktri.hed (run_full.sh:110-116)."""
    return "CL triphones\n" + "".join(
        f"TI T_{v} {{(*-{v}+*,{v}+*,*-{v},{v}).transP}}\n" for v in PHONES)


def _tie_hed() -> str:
    """tie.hed (run_full.sh:125-145)."""
    lines = ["RO 1.0 tri2/stats"]
    for side, pat in (("L", "{ %s-* }"), ("R", "{ *+%s }")):
        for v in PHONES + ["sil"]:
            lines.append(f'QS "{side}_{v}" {pat % v}')
    for p in PHONES:
        for st in (2, 3, 4):
            lines.append(f'TB 10.0 "ST_{p}_{st}_" {{("*-{p}+*","{p}+*",'
                         f'"*-{p}","{p}").state[{st}]}}')
    lines += ["ST trees", "AU alltri", "CO tiedlist"]
    return "\n".join(lines) + "\n"


def write_words_sil() -> None:
    """run_full.sh:175-186: words_train.mlf with SIL after every word and
    at the start, the numerator transcriptions of the forced alignment."""
    with open("words_train.mlf") as f:
        lines = f.read().splitlines()
    out = ["#!MLF!#"]
    for ln in lines[1:]:
        if ln.startswith('"'):
            out += [ln, "SIL"]
        elif ln == ".":
            out.append(".")
        else:
            out += [ln, "SIL"]
    with open("words_sil.mlf", "w") as f:
        f.write("\n".join(out) + "\n")


def write_word_text() -> None:
    """run_full.sh:216-226: each utterance of words_train.mlf as one line
    of words.txt (LBuild's training text)."""
    with open("words_train.mlf") as f:
        lines = f.read().splitlines()
    sents, cur = [], []
    for ln in lines[1:]:
        if ln.startswith('"'):
            cur = []
        elif ln == ".":
            sents.append(" ".join(cur))
        else:
            cur.append(ln)
    with open("words.txt", "w") as f:
        f.write("\n".join(sents) + "\n")


def _herest(out: str, mmf: str, mlf: str, hmmlist: str, extra=()):
    return ["-C", "cfg", "-T", "1", "-I", mlf, "-H", f"{mmf}/hmmdefs", "-M",
            out, *extra, "-S", "train.scp", hmmlist]


def stages() -> List[Tuple[str, object, object]]:
    """The chain as (label, tool module or None, argv or function), in
    run_full.sh's order. HResults stages are labelled "score <stage>"."""
    decode = ["-w", "wdnet.slf", "-p", "-12"]
    return [
        ("cfg", None, _write("cfg", "TARGETKIND = MFCC_E_D_A\n")),
        ("cfg_wav", None, _write(
            "cfg_wav", "SOURCEFORMAT = WAV\nTARGETKIND = MFCC_E_D_A\n")),
        ("HCopy", hcopy, ["-C", "cfg_wav", "-S", "copy.scp"]),
        ("HCompV", hcompv, ["-C", "cfg", "-f", "0.01", "-m", "-M", "hmm0",
                            "-S", "train.scp", "proto"]),
        ("clone_proto", None, clone_monophones),
        *[(f"HERest mono {it}", herest,
           _herest(f"hmm{it}", f"hmm{it - 1}", "phones.mlf", "monophones"))
          for it in (1, 2, 3)],
        ("mktri.led", None, _write("mktri.led", "WB sil\nTC\n")),
        ("HLEd", hled, ["-i", "tri.mlf", "mktri.led", "phones.mlf"]),
        ("triphone lists", None, write_triphone_lists),
        ("mktri.hed", None, _write("mktri.hed", _tri_hed())),
        ("HHEd CL/TI", hhed, ["-H", "hmm3/hmmdefs", "-M", "tri0",
                              "mktri.hed", "monophones"]),
        *[(f"HERest tri {it}", herest,
           _herest(f"tri{it}", f"tri{it - 1}", "tri.mlf", "triphones",
                   ["-s", f"tri{it}/stats"])) for it in (1, 2)],
        ("tie.hed", None, _write("tie.hed", _tie_hed())),
        ("HHEd TB/AU", hhed, ["-T", "1", "-H", "tri2/hmmdefs", "-M", "tri3",
                              "tie.hed", "triphones"]),
        ("HERest tied 1", herest,
         _herest("tied1", "tri3", "tri.mlf", "tiedlist")),
        ("HERest tied 2", herest,
         _herest("tied2", "tied1", "tri.mlf", "tiedlist")),
        ("mu.hed", None, _write("mu.hed", "MU 2 {*.state[2-4].mix}\n")),
        ("HHEd MU", hhed, ["-H", "tied2/hmmdefs", "-M", "mix1", "mu.hed",
                           "tiedlist"]),
        ("HERest mix 2", herest,
         _herest("mix2", "mix1", "tri.mlf", "tiedlist")),
        ("HERest mix 3", herest,
         _herest("mix3", "mix2", "tri.mlf", "tiedlist")),
        ("HBuild", hbuild, ["wlist", "wdnet.slf"]),
        ("HVite", hvite, [*decode, "-i", "rec_tied.mlf", "-H",
                          "mix3/hmmdefs", "-S", "test.scp", "dict",
                          "tiedlist"]),
        ("score tied+mix", hresults, ["-I", "words_test.mlf", "tiedlist",
                                      "rec_tied.mlf"]),
        ("HVite -z", hvite, [*decode, "-z", "lat", "-l", "lats", "-i",
                             "rec_tr.mlf", "-H", "mix3/hmmdefs", "-S",
                             "train.scp", "dict", "tiedlist"]),
        ("words_sil.mlf", None, write_words_sil),
        ("HVite -a -z", hvite, ["-a", "-I", "words_sil.mlf", "-z", "lat",
                                "-l", "numlats", "-i", "align_tr.mlf", "-H",
                                "mix3/hmmdefs", "-S", "train.scp", "dict",
                                "tiedlist"]),
        ("cfg_mmi", None, _write(
            "cfg_mmi", "TARGETKIND = MFCC_E_D_A\nHMMIREST: ISMOOTHTAU = 100"
            "\nHMMIREST: LATPROBSCALE = 0.1\n")),
        ("HMMIRest", hmmirest, ["-C", "cfg_mmi", "-q", "numlats", "-r",
                                "lats", "-d", "dict", "-H", "mix3/hmmdefs",
                                "-M", "mmi1", "-S", "train.scp",
                                "tiedlist"]),
        ("HVite MMI", hvite, [*decode, "-i", "rec_mmi.mlf", "-H",
                              "mmi1/hmmdefs", "-S", "test.scp", "dict",
                              "tiedlist"]),
        ("score MMI", hresults, ["-I", "words_test.mlf", "tiedlist",
                                 "rec_mmi.mlf"]),
        ("HLEd adapt", hled, ["-i", "tri_adapt.mlf", "mktri.led",
                              "phones_adapt.mlf"]),
        ("cfg_ad", None, _write(
            "cfg_ad", "TARGETKIND = MFCC_E_D_A\nHADAPT: TRANSKIND = CMLLR\n"
            "HADAPT: BLOCKS = 3\n")),
        ("HERest -K", herest, ["-C", "cfg_ad", "-I", "tri_adapt.mlf", "-H",
                               "mix3/hmmdefs", "-K", "xforms", "-h",
                               SPK_MASK, "-S", "adapt.scp", "tiedlist"]),
        ("HVite -J", hvite, [*decode, "-J", "xforms", "-h", SPK_MASK, "-i",
                             "rec_ad.mlf", "-H", "mix3/hmmdefs", "-S",
                             "test.scp", "dict", "tiedlist"]),
        ("score adapted", hresults, ["-I", "words_test.mlf", "tiedlist",
                                     "rec_ad.mlf"]),
        ("words.txt", None, write_word_text),
        ("LBuild", lbuild, ["-n", "3", "wmap", "lm3.arpa", "words.txt"]),
        ("HDecode", hdecode, ["-w", "lm3.arpa", "-p", "-12", "-i",
                              "rec_hd.mlf", "-H", "mix3/hmmdefs", "-S",
                              "test.scp", "dict_hd", "tiedlist"]),
        ("score HDecode", hresults, ["-I", "words_test.mlf", "tiedlist",
                                     "rec_hd.mlf"]),
    ]


_DIRS = ("hmm1", "hmm2", "hmm3", "tri0", "tri1", "tri2", "tri3", "tied1",
         "tied2", "mix1", "mix2", "mix3", "lats", "numlats", "mmi1",
         "xforms")


def score_row(stage: str, report: str) -> Tuple[float, float]:
    """(%Corr, %Acc) of an HResults report's WORD line (run_full.sh's
    `score`)."""
    m = re.search(r"%Corr=([0-9.]+), Acc=([0-9.-]+)", report)
    if m is None:
        raise RuntimeError(f"full: no WORD line for {stage}")
    return float(m.group(1)), float(m.group(2))


def check(rows: Dict[str, Tuple[float, float]],
          expected: Dict[str, Tuple[float, float]] = EXPECTED,
          tol: float = TOL) -> List[str]:
    """recipes/full/check_results.py : check on parsed rows: the failures
    (a missing stage, or %Corr or %Acc more than `tol` below the expected
    value; improvements never fail), empty when the recipe passes."""
    bad = []
    for k, (c, a) in expected.items():
        if k not in rows:
            bad.append(f"missing stage {k}")
        elif rows[k][0] < c - tol or rows[k][1] < a - tol:
            bad.append(f"{k}: got {rows[k]}, expected >= "
                       f"({c - tol:.1f}, {a - tol:.1f})")
    return bad


def run_chain(workdir: str, quiet: bool = False, n_train: int = 24,
              n_adapt: int = 8, n_test: int = 12
              ) -> Tuple[List[Tuple[str, float]], Dict[str, Tuple[float,
                                                                float]]]:
    """Write the corpus into `workdir` and run the chain there; returns
    each stage's (label, wall seconds) and each scored stage's (%Corr,
    %Acc), which also go to results.md. Raises RuntimeError when a tool
    exits non-zero. `quiet` keeps the tools' own output off stdout."""
    old = os.getcwd()
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    walls: List[Tuple[str, float]] = []
    rows: Dict[str, Tuple[float, float]] = {}
    try:
        t0 = time.perf_counter()
        make_corpus(n_train, n_adapt, n_test)
        walls.append(("corpus", time.perf_counter() - t0))
        for d in _DIRS:
            os.makedirs(d, exist_ok=True)
        for label, tool, what in stages():
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(
                    out if quiet or tool is hresults else sys.stdout):
                if tool is None:
                    what()
                    rc = 0
                else:
                    rc = tool.main(list(what))
            walls.append((label, time.perf_counter() - t0))
            if rc != 0:
                raise RuntimeError(f"full: {label} exited with {rc}")
            if tool is hresults:
                stage = label.split(" ", 1)[1]
                report = out.getvalue()
                with open(f"hr_{stage}.txt", "w") as f:
                    f.write(report)
                rows[stage] = score_row(stage, report)
        with open("results.md", "w") as f:
            f.write("| stage | %Corr | %Acc |\n|---|---|---|\n")
            for stage, (c, a) in rows.items():
                f.write(f"| {stage} | {c:.2f} | {a:.2f} |\n")
    finally:
        os.chdir(old)
    return walls, rows


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    work = argv[0] if argv else tempfile.mkdtemp(prefix="full_")
    print(f"== full-recipe workdir: {work} (device {default_device()})")
    walls, rows = run_chain(work)
    for label, s in walls:
        print(f"full: {label:<16s} {s:9.3f} s")
    with open(os.path.join(work, "results.md")) as f:
        print(f.read(), end="")
    bad = check(rows)
    if bad:
        print("FULL RECIPE REGRESSION:", *bad, sep="\n  ")
        return 1
    print("== FULL RECIPE PASSED (all stages within tolerance)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
