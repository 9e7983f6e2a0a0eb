"""The demo chain of recipes/demo/run_demo.sh, every stage, on
htk_tpu_torch.

The twin of `recipes/demo/run_demo.sh:24-152` (which drives the console
scripts bound to htk_tpu). It writes the corpus of
`recipes/demo/make_corpus.py` (10 utterances, seed 21: the same words,
dict, wlist, MLFs and proto) with the port's own synthesizer
(recipes/speech.py), then runs every tool of the chain in-process through
its `main`, with run_demo.sh's arguments:

  HCopy -> HCompV -> HERest x3 (monophones)
  HLEd WB/TC -> HHEd CL/TI -> HERest x2 -> HHEd TB tying -> HERest
  HHEd MU (mixtures) -> HERest
  HBuild -> HVite -z (lattices) -> HResults      [must be 100%]
  HMMIRest (MMI over the lattices) -> HVite -> HResults
                                                 [must reach Acc=100.00]
  cfg_dnn -> HNTrainSGD -e 15 -> HVite -N (hybrid) -> HResults
                                                 [WORD line, no gate]
  words.txt -> LBuild -n 3 -> dict_hd -> HDecode (trigram) -> HResults
                                                 [must reach Acc=100.00]

The inline Python and shell steps of run_demo.sh are functions here:
`clone_monophones` (:31-38), `write_triphone_list` (:50-57),
`write_word_text` (:124-135), `_hd_dict` (:140-149) and the cfg_dnn
file (:117). The device work (the frontend, HERest's and HMMIRest's
forward-backward, HNTrainSGD's alignment and training, HVite's and
HDecode's decodes) runs on `tools/_common.default_device()`: the CUDA
card, or the CPU when HTK_TPU_TORCH_DEVICE=cpu asks for it.

Usage: python -m htk_tpu_torch.recipes.demo [workdir]
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
import tempfile
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..io.mmf import load_mmf, save_mmf
from ..models.proto import clone_proto, make_proto
from ..tools import (hbuild, hcompv, hcopy, hdecode, herest, hhed, hled,
                     hmmirest, hntrainsgd, hresults, hvite, lbuild)
from ..tools._common import default_device
from .speech import synth_words, write_wav

WORDS = {"ONE": ["aa", "iy"], "TWO": ["iy", "uw"],
         "THREE": ["uw", "aa", "iy"]}
PASS_LINE = "WORD: %Corr=100.00, Acc=100.00"
ACC_PASS = "Acc=100.00"  # run_demo.sh:113's and :151's check
# run_demo.sh:117's DNN configuration
CFG_DNN = ("HNTRAINSGD: HIDDENSIZE = 128\nHNTRAINSGD: CONTEXT = 2\n"
           "HNTRAINSGD: LEARNRATE = 0.05\nHNTRAINSGD: ACTIVATION = RELU\n"
           "TARGETKIND = MFCC_E_D_A\n")


def _vowels(words) -> List[str]:
    return sorted({p for prons in words.values() for p in prons})


def _tri_hed(vowels) -> str:
    """mktri.hed (run_demo.sh:58-63): clone, then tie each vowel's
    triphones' transition matrices."""
    return "CL triphones\n" + "".join(
        f"TI T_{v} {{(*-{v}+*,{v}+*,*-{v},{v}).transP}}\n" for v in vowels)


def _tie_hed(vowels) -> str:
    """tie.hed (run_demo.sh:72-89): context questions and a decision tree
    for each emitting state of each vowel."""
    lines = ["RO 1.0 tri2/stats"]
    for side, pat in (("L", "{ %s-* }"), ("R", "{ *+%s }")):
        for v in vowels:
            lines.append(f'QS "{side}_{v}" {pat % v}')
    for v in vowels:
        for st in (2, 3, 4):
            lines.append(f'TB 10.0 "ST_{v}_{st}_" {{("*-{v}+*","{v}+*",'
                         f'"*-{v}","{v}").state[{st}]}}')
    lines.append("ST trees")
    return "\n".join(lines) + "\n"


def make_corpus(n_train: int = 10, seed: int = 21, words=None,
                n_words: int = 3) -> None:
    """Write make_corpus.py's corpus into the current directory: with the
    defaults, the same words, transcriptions and samples. `words` maps
    each word to its vowels; an utterance holds `n_words` of them."""
    words = WORDS if words is None else words
    rng = np.random.default_rng(seed)
    wnames = list(words)
    word_seqs, phone_seqs = [], []
    for i in range(n_train):
        ws = [wnames[int(x)]
              for x in rng.integers(0, len(wnames), size=n_words)]
        phs = ["sil"]
        for w in ws:
            phs += words[w] + ["sil"]
        word_seqs.append(ws)
        phone_seqs.append(phs)
        write_wav(f"u{i}.wav", synth_words(phs, rng))
    with open("phones.mlf", "w") as f:
        f.write("#!MLF!#\n")
        for i, phs in enumerate(phone_seqs):
            f.write(f'"*/u{i}.lab"\n' + "\n".join(phs) + "\n.\n")
    with open("words.mlf", "w") as f:
        f.write("#!MLF!#\n")
        for i, ws in enumerate(word_seqs):
            f.write(f'"*/u{i}.lab"\n' + "\n".join(ws) + "\n.\n")
    with open("copy.scp", "w") as f:
        f.write("\n".join(f"u{i}.wav u{i}.mfc" for i in range(n_train))
                + "\n")
    with open("train.scp", "w") as f:
        f.write("\n".join(f"u{i}.mfc" for i in range(n_train)) + "\n")
    with open("monophones", "w") as f:
        f.write("".join(f"{p}\n" for p in _vowels(words)) + "sil\n")
    with open("dict", "w") as f:
        f.write("".join(f"{w}  {' '.join(p)}\n" for w, p in words.items())
                + "SIL [] sil\n")
    with open("wlist", "w") as f:
        f.write("".join(f"{w}\n" for w in words) + "SIL\n")
    save_mmf(make_proto(nstates=5, dim=39, parm_kind="MFCC_E_D_A"), "proto")
    with open("cfg_wav", "w") as f:
        f.write("SOURCEFORMAT = WAV\nTARGETKIND = MFCC_E_D_A\n")
    with open("cfg", "w") as f:
        f.write("TARGETKIND = MFCC_E_D_A\n")


def clone_monophones() -> None:
    """run_demo.sh:31-38: one copy of the flat-start proto per monophone,
    with HCompV's variance floor."""
    hs = load_mmf("hmm0/proto")
    with open("monophones") as f:
        cl = clone_proto(hs, "proto", f.read().split())
    cl.macros["v"]["varFloor1"] = \
        load_mmf("hmm0/vFloors").macros["v"]["varFloor1"]
    save_mmf(cl, "hmm0/hmmdefs")


def write_triphone_list() -> None:
    """run_demo.sh:50-57: every label of tri.mlf, sorted."""
    names = set()
    with open("tri.mlf") as f:
        for ln in f:
            ln = ln.strip()
            if ln and not ln.startswith(("#", '"', ".")):
                names.add(ln)
    with open("triphones", "w") as f:
        f.write("\n".join(sorted(names)) + "\n")


def write_word_text() -> None:
    """run_demo.sh:124-135: each utterance of words.mlf as one line of
    words.txt (LBuild's training text)."""
    with open("words.mlf") as f:
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


def _hd_dict(words) -> str:
    """dict_hd (run_demo.sh:140-149): each word's pronunciation, and with
    a trailing silence, plus the <s>/</s> silence entries (STARTWORD /
    ENDWORD) that model the utterance-edge silence."""
    return "".join(f"{w}  {' '.join(p)}\n{w}  {' '.join(p)} sil\n"
                   for w, p in words.items()) + "<s> []  sil\n</s> []  sil\n"


def _write(path: str, text: str) -> Callable[[], None]:
    def step():
        with open(path, "w") as f:
            f.write(text)
    return step


def stages(vowels=("aa", "iy", "uw"), words=None
           ) -> List[Tuple[str, object, object]]:
    """The chain as (label, tool module or None, argv or function), with
    the tying scripts written for `vowels` and HDecode's dictionary for
    `words` (word -> vowels; the demo's WORDS by default)."""
    words = WORDS if words is None else words
    herest_mono = [
        (f"HERest mono {it}", herest,
         ["-C", "cfg", "-T", "1", "-I", "phones.mlf", "-H",
          f"hmm{it - 1}/hmmdefs", "-M", f"hmm{it}", "-S", "train.scp",
          "monophones"]) for it in (1, 2, 3)]
    herest_tri = [
        (f"HERest tri {it}", herest,
         ["-C", "cfg", "-T", "1", "-I", "tri.mlf", "-H",
          f"tri{it - 1}/hmmdefs", "-M", f"tri{it}", "-s",
          f"tri{it}/stats", "-S", "train.scp", "triphones"])
        for it in (1, 2)]
    return [
        ("HCopy", hcopy, ["-C", "cfg_wav", "-S", "copy.scp"]),
        ("HCompV", hcompv, ["-C", "cfg", "-f", "0.01", "-m", "-M", "hmm0",
                            "-S", "train.scp", "proto"]),
        ("clone_proto", None, clone_monophones),
        *herest_mono,
        ("mktri.led", None, _write("mktri.led", "WB sil\nTC\n")),
        ("HLEd", hled, ["-i", "tri.mlf", "mktri.led", "phones.mlf"]),
        ("triphone list", None, write_triphone_list),
        ("mktri.hed", None, _write("mktri.hed", _tri_hed(vowels))),
        ("HHEd CL/TI", hhed, ["-H", "hmm3/hmmdefs", "-M", "tri0",
                              "mktri.hed", "monophones"]),
        *herest_tri,
        ("tie.hed", None, _write("tie.hed", _tie_hed(vowels))),
        ("HHEd TB", hhed, ["-T", "1", "-H", "tri2/hmmdefs", "-M", "tri3",
                           "tie.hed", "triphones"]),
        ("HERest tied", herest,
         ["-C", "cfg", "-T", "1", "-I", "tri.mlf", "-H", "tri3/hmmdefs",
          "-M", "tied1", "-S", "train.scp", "triphones"]),
        ("mu.hed", None, _write("mu.hed", "MU 2 {*.state[2-4].mix}\n")),
        ("HHEd MU", hhed, ["-H", "tied1/hmmdefs", "-M", "mix1", "mu.hed",
                           "triphones"]),
        ("HERest mix", herest,
         ["-C", "cfg", "-T", "1", "-I", "tri.mlf", "-H", "mix1/hmmdefs",
          "-M", "tied2", "-S", "train.scp", "triphones"]),
        ("HBuild", hbuild, ["wlist", "wdnet.slf"]),
        ("HVite -z", hvite, ["-w", "wdnet.slf", "-p", "-10", "-z", "lat",
                             "-l", "lats", "-i", "rec.mlf", "-H",
                             "tied2/hmmdefs", "-S", "train.scp", "dict",
                             "triphones"]),
        ("HResults", hresults, ["-I", "words.mlf", "triphones", "rec.mlf"]),
        ("HMMIRest", hmmirest, ["-I", "tri.mlf", "-r", "lats", "-d", "dict",
                                "-H", "tied2/hmmdefs", "-M", "mmi1", "-S",
                                "train.scp", "triphones"]),
        ("HVite MMI", hvite, ["-w", "wdnet.slf", "-p", "-10", "-i",
                              "recmmi.mlf", "-H", "mmi1/hmmdefs", "-S",
                              "train.scp", "dict", "triphones"]),
        ("HResults MMI", hresults, ["-I", "words.mlf", "triphones",
                                    "recmmi.mlf"]),
        ("cfg_dnn", None, _write("cfg_dnn", CFG_DNN)),
        ("HNTrainSGD", hntrainsgd, ["-C", "cfg_dnn", "-e", "15", "-I",
                                    "tri.mlf", "-H", "tied2/hmmdefs", "-M",
                                    "dnn", "-S", "train.scp", "triphones"]),
        ("HVite -N", hvite, ["-w", "wdnet.slf", "-p", "-10", "-N", "dnn/ann",
                             "-i", "recdnn.mlf", "-H", "tied2/hmmdefs", "-S",
                             "train.scp", "dict", "triphones"]),
        ("HResults DNN", hresults, ["-I", "words.mlf", "triphones",
                                    "recdnn.mlf"]),
        ("words.txt", None, write_word_text),
        ("LBuild", lbuild, ["-n", "3", "wmap", "lm3.arpa", "words.txt"]),
        ("dict_hd", None, _write("dict_hd", _hd_dict(words))),
        ("HDecode", hdecode, ["-w", "lm3.arpa", "-p", "-10", "-i",
                              "rechd.mlf", "-H", "tied2/hmmdefs", "-S",
                              "train.scp", "dict_hd", "triphones"]),
        ("HResults HDecode", hresults, ["-I", "words.mlf", "triphones",
                                        "rechd.mlf"]),
    ]


# what each scoring stage's report must hold (run_demo.sh:105, :113,
# :151); the DNN stage's report (:121) has no gate
PASS = {"HResults": PASS_LINE, "HResults MMI": ACC_PASS,
        "HResults HDecode": ACC_PASS}


_DIRS = ("tri0", "tri1", "tri2", "tri3", "tied1", "mix1", "tied2", "lats",
         "mmi1", "dnn")


def word_line(report: str) -> str:
    """The WORD line of an HResults report (run_demo.sh:121's grep)."""
    return next((ln for ln in report.splitlines() if "WORD" in ln), "")


def run_chain(workdir: str, quiet: bool = False) -> List[Tuple[str, float]]:
    """Write the corpus into `workdir` and run the chain there; returns
    each stage's (label, wall seconds). Raises RuntimeError when a tool
    exits non-zero, HResults does not report 100% word accuracy for
    HVite, or the MMI and HDecode stages' word accuracy is not 100%.
    `quiet` keeps the tools' own output off stdout (HResults' reports
    are printed either way, and each is kept as `<label>.txt`: HResults'
    as results.txt, as run_demo.sh keeps it)."""
    old = os.getcwd()
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    walls: List[Tuple[str, float]] = []
    try:
        t0 = time.perf_counter()
        make_corpus()
        walls.append(("corpus", time.perf_counter() - t0))
        for d in _DIRS + ("hmm1", "hmm2", "hmm3"):
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
                raise RuntimeError(f"demo: {label} exited with {rc}")
            if tool is hresults:
                report = out.getvalue()
                print(report, end="")
                name = ("results" if label == "HResults"
                        else label.replace(" ", "_"))
                with open(f"{name}.txt", "w") as f:
                    f.write(report)
                if label in PASS and PASS[label] not in report:
                    raise RuntimeError(f"DEMO FAILED: {label}: not "
                                       f"{PASS[label]}")
    finally:
        os.chdir(old)
    return walls


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    work = argv[0] if argv else tempfile.mkdtemp(prefix="demo_")
    print(f"== demo workdir: {work} (device {default_device()})")
    walls = run_chain(work)
    for label, s in walls:
        print(f"demo: {label:<16s} {s:9.3f} s")
    with open(os.path.join(work, "HResults_DNN.txt")) as f:
        print(f"demo: DNN hybrid {word_line(f.read())}")
    print("== DEMO PASSED: every stage of run_demo.sh (100% word accuracy "
          "at HVite, MMI and HDecode)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
