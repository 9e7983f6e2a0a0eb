"""HResults — recognition results analysis.

Mirrors `HTKTools/HResults.c`: DP string alignment of recognised vs
reference transcriptions with HTK's edit costs (ins=7, del=7, sub=10),
reporting sentence and word %Correct / Accuracy in HTK's table format,
optional confusion matrix (-p) and speaker-by-speaker breakdown (-k).

Usage: HResults [options] hmmList recFiles...

  -I mlf   reference MLF (repeatable)
  -L dir   reference label dir      -X ext  reference extension
  -e a b   make label a equivalent to b (repeatable; b may be ???
           meaning delete)          -p      print confusion matrix
  -t       output per-utterance alignments
  -s       strip triphone contexts before scoring
  -k mask  speaker mask (% captures): per-speaker breakdown table
  -d N     score the best of the first N recognition alternatives
           (oracle scoring of HVite -n N-best output)
  -n       NIST/sclite-style output table [LC layout vs HResults.c]
  -w       word-spotting analysis: per-keyword hits/FAs and Figure of
           Merit (keywords = the hmmList; rec labels need scores+times)
  Standard: -A -C -D -S -T -V

Copied from `htk_tpu/tools/hresults.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot import htk_tpu, whose
utils package pulls in JAX. `speaker_from_mask` (for -k) is copied
beside it from `htk_tpu/algo/adapt.py`.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

from ..io.mlf import MLF, find_labels, load_label_file
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, HRError

USAGE = "Usage: HResults [options] hmmList recFiles..."

OPTS = {
    "I": Option("I", 1, "reference MLF", repeatable=True),
    "L": Option("L", 1, "reference label dir"),
    "X": Option("X", 1, "reference label ext"),
    "e": Option("e", 2, "label equivalence", repeatable=True),
    "p": Option("p", 0, "confusion matrix"),
    "t": Option("t", 0, "print alignments"),
    "s": Option("s", 0, "strip triphone contexts"),
    "f": Option("f", 0, "full results"),
    "k": Option("k", 1, "speaker mask (per-speaker breakdown)"),
    "d": Option("d", 1, "score best of N alternatives", typ=int),
    "n": Option("n", 0, "NIST format output"),
    "w": Option("w", 0, "word spotting analysis (FOM)"),
}

SUB_COST, INS_COST, DEL_COST = 10, 7, 7



def speaker_from_mask(mask: str, name: str) -> str:
    """Extract the speaker id from a filename using an HTK -h mask.

    HTK masks use `%` to capture one speaker-name character and `*` as a
    wildcard, e.g. `*/%%%_*.mfc` captures the first 3 chars of the
    basename. Matching follows HAdapt's MaskMatch semantics; returns the
    captured characters, or the whole basename when the mask doesn't
    match (with a warning at the caller).

    Copied from `htk_tpu/algo/adapt.py`, which the port does not carry
    yet (adaptation waits for its own slice).
    """
    import os as _os

    cand = name
    base = _os.path.basename(name)

    def match(m: str, s: str):
        # returns captured string or None; simple backtracking matcher
        if not m:
            return "" if not s else None
        if m[0] == "*":
            for k in range(len(s) + 1):
                r = match(m[1:], s[k:])
                if r is not None:
                    return r
            return None
        if not s:
            return None
        if m[0] == "%":
            r = match(m[1:], s[1:])
            return None if r is None else s[0] + r
        if m[0] == "?" or m[0] == s[0]:
            r = match(m[1:], s[1:])
            return r
        return None

    for target in (name, base):
        got = match(mask, target)
        if got:
            return got
    return _os.path.splitext(base)[0]

def dp_align(ref: List[str], hyp: List[str]):
    """HTK DP alignment; returns (hits, subs, dels, ins, pairs)."""
    n, m = len(ref), len(hyp)
    cost = [[0] * (m + 1) for _ in range(n + 1)]
    back = [[0] * (m + 1) for _ in range(n + 1)]  # 1=diag 2=del(ref) 3=ins(hyp)
    for i in range(1, n + 1):
        cost[i][0] = cost[i - 1][0] + DEL_COST
        back[i][0] = 2
    for j in range(1, m + 1):
        cost[0][j] = cost[0][j - 1] + INS_COST
        back[0][j] = 3
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            d = cost[i - 1][j - 1] + (0 if ref[i - 1] == hyp[j - 1] else SUB_COST)
            dl = cost[i - 1][j] + DEL_COST
            ins = cost[i][j - 1] + INS_COST
            best = min(d, dl, ins)
            cost[i][j] = best
            back[i][j] = 1 if best == d else (2 if best == dl else 3)
    # trace
    i, j = n, m
    pairs: List[Tuple[Optional[str], Optional[str]]] = []
    while i > 0 or j > 0:
        b = back[i][j]
        if b == 1:
            pairs.append((ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif b == 2:
            pairs.append((ref[i - 1], None))
            i -= 1
        else:
            pairs.append((None, hyp[j - 1]))
            j -= 1
    pairs.reverse()
    hits = sum(1 for r, h in pairs if r is not None and r == h)
    subs = sum(1 for r, h in pairs if r is not None and h is not None and r != h)
    dels = sum(1 for r, h in pairs if h is None)
    ins = sum(1 for r, h in pairs if r is None)
    return hits, subs, dels, ins, pairs


_TRI_RE = re.compile(r"^(?:[^-]+-)?([^+]+?)(?:\+.+)?$")


def strip_context(name: str) -> str:
    m = _TRI_RE.match(name)
    return m.group(1) if m else name




def _word_spotting(ta, rec_entries, mlfs, ref_dir, ref_ext) -> int:
    """-w: keyword-spotting analysis (HResults.c word spotting mode).

    Keywords are the names in the hmmList argument. A putative hit (a
    rec label with a score) is TRUE if its midpoint falls inside an
    unclaimed reference occurrence of the keyword, else a false alarm.
    FOM = the average of the detection percentages as the threshold
    sweeps from 0 to 10 false alarms per hour (the standard HTK/NIST
    figure of merit; fractional last band interpolated [LC vs
    HResults.c's exact interpolation]).
    """
    from ..io.mmf import load_hmm_list

    keywords = [l for l, _p in load_hmm_list(ta.args[0], ta.config)]
    # spots per keyword: (score, utt_key, mid_time_100ns)
    spots: Dict[str, list] = {k: [] for k in keywords}
    refs: Dict[str, list] = {k: [] for k in keywords}
    total_dur_100ns = 0
    for key, rec_tr in rec_entries:
        stem = os.path.splitext(os.path.basename(key))[0]
        try:
            ref_tr = find_labels(stem, mlfs, ref_dir, ref_ext)
        except Exception:
            HRError(3331, "HResults: no reference for %s", key)
            continue
        utt_end = 0
        for l in ref_tr.labels:
            if l.end is not None:
                utt_end = max(utt_end, l.end)
            if l.name in refs:
                refs[l.name].append([stem, l.start or 0, l.end or 0, False])
        total_dur_100ns += utt_end
        for l in rec_tr.labels:
            if l.name in spots:
                mid = ((l.start or 0) + (l.end or 0)) / 2.0
                spots[l.name].append((l.score or 0.0, stem, mid))
    hours = total_dur_100ns / 3.6e10
    if hours <= 0:
        HError(3332, "HResults -w: reference labels carry no times")
    print("------------------------ Figure of Merit --------------------------")
    print("    KeyWord:    #Hits     #FAs  #Actual      FOM")
    foms = []
    for k in keywords:
        occ = refs[k]
        n_true = len(occ)
        hits = fas = 0
        # detection percentage after each false alarm count
        p_at_fa = []  # p_at_fa[i] = %hits with <= i FAs (i from 0)
        cur_hits = 0
        events = sorted(spots[k], key=lambda t: -t[0])
        for score, stem, mid in events:
            hit = False
            for o in occ:
                if not o[3] and o[0] == stem and o[1] <= mid <= o[2]:
                    o[3] = True
                    hit = True
                    break
            if hit:
                cur_hits += 1
            else:
                p_at_fa.append(cur_hits)
        p_at_fa.append(cur_hits)  # tail: no further FAs
        n_hits, n_fa = cur_hits, len(p_at_fa) - 1

        def pct(i):
            c = p_at_fa[min(i, len(p_at_fa) - 1)]
            return 100.0 * c / max(n_true, 1)

        # FOM = (p1 + .. + pN + a*p(N+1)) / (10T), pi = % true hits
        # found before the i-th false alarm = p_at_fa[i-1]
        fom = 0.0
        n_bands = 10.0 * hours
        full = int(n_bands)
        for i in range(1, full + 1):
            fom += pct(i - 1)
        frac = n_bands - full
        if frac > 0:
            fom += frac * pct(full)
        fom /= max(n_bands, 1e-9)
        foms.append(fom)
        print(f"{k:>11}: {n_hits:8d} {n_fa:8d} {n_true:8d} {fom:8.2f}")
    mean_fom = sum(foms) / max(len(foms), 1)
    print(f"    Overall: {mean_fom:37.2f}")
    print("===================================================================")
    from ..utils.metrics import emit_metric

    emit_metric(ta.config, "HResults", fom=round(mean_fom, 4))
    return 0


def run(argv: List[str]) -> int:
    ta = parse_args("HResults", argv, OPTS, min_args=1, usage=USAGE)
    rec_files = ta.script + ta.args[1:]
    if not rec_files:
        HError(1030, "HResults: no recognition files\n%s", USAGE)
    mlfs = [MLF.load(p, ta.config) for p in ta.get_all("I")]
    ref_dir = ta.get("L")
    ref_ext = ta.get("X", "lab")

    equiv: Dict[str, str] = {}
    for a, b in [v if isinstance(v, tuple) else (v,) for v in ta.get_all("e")]:
        equiv[b] = a  # map b -> a (HTK: -e a b makes b equivalent to a)

    def norm(names: List[str]) -> List[str]:
        out = []
        for n in names:
            if ta.has("s"):
                n = strip_context(n)
            n = equiv.get(n, n)
            if n == "???":
                continue
            out.append(n)
        return out

    tot_h = tot_s = tot_d = tot_i = tot_n = 0
    sent_ok = sent_n = 0
    confusion: Dict[Tuple[str, str], int] = {}
    # -k mask: per-speaker tallies [h, d, s, i, n, snt, snt_ok]
    spk_mask = ta.get("k")
    by_spk: Dict[str, List[int]] = {}

    # rec files may be label files or MLFs
    rec_entries = []  # (key, Transcription)
    for rf in rec_files:
        try:
            first = open(rf).readline().strip()
        except OSError as e:
            HError(3310, "HResults: cannot open %s (%s)", rf, e)
        if first == "#!MLF!#":
            m = MLF.load(rf, ta.config)
            rec_entries.extend(m.entries)
        else:
            rec_entries.append((rf, load_label_file(rf)))

    if ta.has("w"):
        return _word_spotting(ta, rec_entries, mlfs, ref_dir, ref_ext)

    n_best = int(ta.get("d", 0) or 0)
    for key, rec_tr in rec_entries:
        stem = os.path.splitext(os.path.basename(key))[0]
        try:
            ref_tr = find_labels(stem, mlfs, ref_dir, ref_ext)
        except Exception:
            HRError(3331, "HResults: no reference for %s", key)
            continue
        ref = norm([l.name for l in ref_tr.labels])
        # -d N: oracle-score the best of the first N alternatives
        alts = (rec_tr.alternatives[:n_best] if n_best
                else rec_tr.alternatives[:1]) or [[]]
        best = None
        for alt in alts:
            hyp = norm([l.name for l in alt])
            h, s, d, i, pairs = dp_align(ref, hyp)
            if best is None or (s + d + i) < (best[1] + best[2] + best[3]):
                best = (h, s, d, i, pairs)
        h, s, d, i, pairs = best
        tot_h += h
        tot_s += s
        tot_d += d
        tot_i += i
        tot_n += len(ref)
        sent_n += 1
        if s == 0 and d == 0 and i == 0:
            sent_ok += 1
        if spk_mask:
            t = by_spk.setdefault(speaker_from_mask(spk_mask, key),
                                  [0, 0, 0, 0, 0, 0, 0])
            t[0] += h
            t[1] += d
            t[2] += s
            t[3] += i
            t[4] += len(ref)
            t[5] += 1
            t[6] += int(s == 0 and d == 0 and i == 0)
        for r, hh in pairs:
            if r is not None and hh is not None and r != hh:
                confusion[(r, hh)] = confusion.get((r, hh), 0) + 1
        if ta.has("t"):
            print(f"Aligned transcription: {stem}")
            print(" REF: " + " ".join(r if r else "*" for r, _ in pairs))
            print(" HYP: " + " ".join(h if h else "*" for _, h in pairs))

    if sent_n == 0:
        HError(3332, "HResults: nothing scored")
    corr = 100.0 * tot_h / max(tot_n, 1)
    acc = 100.0 * (tot_h - tot_i) / max(tot_n, 1)
    scorr = 100.0 * sent_ok / sent_n
    print("====================== HTK Results Analysis =======================")
    print(f"  Date: (htk_tpu)")
    print(f"  Ref : {' '.join(ta.get_all('I')) or ref_dir or '.'}")
    print(f"  Rec : {rec_files[0]}{' ...' if len(rec_files) > 1 else ''}")
    print("------------------------ Overall Results --------------------------")
    if ta.has("n"):
        # NIST/sclite-style summary [LC layout vs HResults.c NIST mode:
        # percentages of sub/del/ins/err over the reference word count,
        # S.Err over sentences]
        nn = max(tot_n, 1)
        print(",===================================================================.")
        print("|         |  # Snt  # Wrd  |  Corr     Sub     Del     Ins     Err  |")
        print("|---------+----------------+----------------------------------------|")
        print(f"| Sum/Avg | {sent_n:6d} {tot_n:6d}  | "
              f"{corr:6.2f} {100.0 * tot_s / nn:7.2f} "
              f"{100.0 * tot_d / nn:7.2f} {100.0 * tot_i / nn:7.2f} "
              f"{100.0 * (tot_s + tot_d + tot_i) / nn:7.2f} |")
        print("`==================================================================='")
    else:
        print(f"SENT: %Correct={scorr:.2f} [H={sent_ok}, S={sent_n - sent_ok}, "
              f"N={sent_n}]")
        print(f"WORD: %Corr={corr:.2f}, Acc={acc:.2f} [H={tot_h}, D={tot_d}, "
              f"S={tot_s}, I={tot_i}, N={tot_n}]")
    from ..utils.metrics import emit_metric

    emit_metric(ta.config, "HResults", corr=round(corr, 4),
                acc=round(acc, 4), sent_correct=round(scorr, 4),
                h=tot_h, d=tot_d, s=tot_s, i=tot_i, n=tot_n)
    if spk_mask and by_spk:
        # HResults.c speaker-by-speaker breakdown table
        print(",-------------------------------------------------------------------.")
        print("| SPKR   | # Snt |  Corr     Sub     Del     Ins     Err    S. Err  |")
        print("|--------+-------+--------------------------------------------------|")
        for spk in sorted(by_spk):
            h, d, su, i, n, snt, sok = by_spk[spk]
            n = max(n, 1)
            print(f"| {spk:<6} | {snt:5d} | {100.0 * h / n:6.2f} "
                  f"{100.0 * su / n:7.2f} {100.0 * d / n:7.2f} "
                  f"{100.0 * i / n:7.2f} {100.0 * (su + d + i) / n:7.2f} "
                  f"{100.0 * (snt - sok) / max(snt, 1):8.2f}  |")
        print("`-------------------------------------------------------------------'")
    if ta.has("p") and confusion:
        print("------------------------ Confusion Matrix -------------------------")
        for (r, hh), c in sorted(confusion.items(), key=lambda kv: -kv[1]):
            print(f"  {r:>12} -> {hh:<12} {c}")
    print("===================================================================")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
