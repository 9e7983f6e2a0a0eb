"""n-gram language models (ARPA format).

Mirrors `HTKLib/HLM.c : ReadLModel()/GetLMProb()` for the decode-side LM:
ARPA back-off files up to trigram. Log probs in the file are base-10
(ARPA convention); accessors return natural logs (HTK works in ln).

Copied from `htk_tpu/io/lm.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX. The native ARPA codec (htk_tpu/native) is
left out: `read_arpa` always takes the Python reader, which builds the
same dicts (`PackedNGramLM` stays for the binary reader).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.errors import HError, contained

LN10 = math.log(10.0)


@dataclass
class NGramLM:
    order: int = 2
    # unigrams: word -> (ln prob, ln backoff)
    unigrams: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    # bigrams: (w1, w2) -> (ln prob, ln backoff)
    bigrams: Dict[Tuple[str, str], Tuple[float, float]] = field(default_factory=dict)
    trigrams: Dict[Tuple[str, str, str], float] = field(default_factory=dict)
    # trigram back-off weights (for 4-gram models)
    tri_bo: Dict[Tuple[str, str, str], float] = field(default_factory=dict)
    fourgrams: Dict[Tuple[str, str, str, str], float] = field(
        default_factory=dict)

    @property
    def vocab(self) -> List[str]:
        return list(self.unigrams)

    def logp_uni(self, w: str) -> float:
        e = self.unigrams.get(w)
        return e[0] if e else -99.0 * LN10

    def logp_bi(self, w1: str, w2: str) -> float:
        """ln P(w2 | w1) with back-off."""
        e = self.bigrams.get((w1, w2))
        if e is not None:
            return e[0]
        u1 = self.unigrams.get(w1)
        bo = u1[1] if u1 else 0.0
        return bo + self.logp_uni(w2)

    def logp_tri(self, w1: str, w2: str, w3: str) -> float:
        e = self.trigrams.get((w1, w2, w3))
        if e is not None:
            return e
        b12 = self.bigrams.get((w1, w2))
        bo = b12[1] if b12 else 0.0
        return bo + self.logp_bi(w2, w3)

    def bigram_arrays(self, words: List[str], extra: Tuple[str, ...] = ()):
        """Explicit bigrams restricted to `words` (+ `extra` words,
        indexed after them): (i, j, p) int64/int64/float64 arrays with p
        in natural logs, in dict/file order. The vectorised consumers
        (algo/lvnet network compile, HBuild) use this instead of
        iterating 10^6-entry dicts in Python."""
        pos = {}
        for k, w in enumerate(list(words) + list(extra)):
            pos[w] = k
        ii: List[int] = []
        jj: List[int] = []
        pp: List[float] = []
        for (w1, w2), (p, _bo) in self.bigrams.items():
            a = pos.get(w1)
            b = pos.get(w2)
            if a is not None and b is not None:
                ii.append(a)
                jj.append(b)
                pp.append(p)
        return (np.asarray(ii, np.int64), np.asarray(jj, np.int64),
                np.asarray(pp, np.float64))

    def logp_4(self, w1: str, w2: str, w3: str, w4: str) -> float:
        e = self.fourgrams.get((w1, w2, w3, w4))
        if e is not None:
            return e
        bo = self.tri_bo.get((w1, w2, w3), 0.0)
        return bo + self.logp_tri(w2, w3, w4)

    def bigram_bow_arrays(self, words: List[str], extra: Tuple[str, ...] = ()):
        """Bigram back-off weights restricted to `words` (+ `extra`,
        indexed after them): (i, j, bow) arrays, dict/file order.
        Contexts with bow == 0 are included (presence = the (u, w)
        context exists, which trigram back-off semantics needs)."""
        pos = {}
        for k, w in enumerate(list(words) + list(extra)):
            pos[w] = k
        ii: List[int] = []
        jj: List[int] = []
        bb: List[float] = []
        for (w1, w2), (_p, bo) in self.bigrams.items():
            a = pos.get(w1)
            b = pos.get(w2)
            if a is not None and b is not None:
                ii.append(a)
                jj.append(b)
                bb.append(bo)
        return (np.asarray(ii, np.int64), np.asarray(jj, np.int64),
                np.asarray(bb, np.float64))

    def trigram_arrays(self, words: List[str], extra: Tuple[str, ...] = ()):
        """Explicit trigrams restricted to `words` (+ `extra`, indexed
        after them): (i, j, k, p) arrays with p in natural logs."""
        pos = {}
        for k, w in enumerate(list(words) + list(extra)):
            pos[w] = k
        ii: List[int] = []
        jj: List[int] = []
        kk: List[int] = []
        pp: List[float] = []
        for (w1, w2, w3), p in self.trigrams.items():
            a = pos.get(w1)
            b = pos.get(w2)
            c = pos.get(w3)
            if a is not None and b is not None and c is not None:
                ii.append(a)
                jj.append(b)
                kk.append(c)
                pp.append(p)
        return (np.asarray(ii, np.int64), np.asarray(jj, np.int64),
                np.asarray(kk, np.int64), np.asarray(pp, np.float64))


class PackedNGramLM(NGramLM):
    """Array-backed NGramLM (the native ARPA codec's output, and the
    binary container's natural in-memory form).

    Holds the n-gram tables as packed numpy arrays — `packs[n] =
    (ids (count, n) uint32 into `vocab`, logp (count,) f64 natural log,
    bo (count,) f64 natural log, has_bo (count,) bool)` in file order —
    and materialises the base class's dicts lazily on first access, so
    dict consumers (perplexity, lattice rescoring, LM editing tools) see
    exactly what the pure-Python reader builds while the vectorised
    consumers (algo/lvnet, HBuild) never pay the 10^6-entry dict
    construction. Duplicate n-gram lines resolve last-wins in the dicts
    (dict semantics) and max-wins in `bigram_arrays` consumers (the
    decoder maxes over parallel arcs); real ARPA files carry unique
    n-grams so the two never diverge in practice."""

    def __init__(self, packs: dict):
        self._packs = packs
        self._vocab_list: List[str] = packs["vocab"]
        self._widx: Optional[Dict[str, int]] = None
        self._wobj: Optional[np.ndarray] = None
        self.order = max(2, int(packs["order"]))

    # -- lazy dict materialisation -------------------------------------
    def _words_obj(self) -> np.ndarray:
        if self._wobj is None:
            self._wobj = np.array(self._vocab_list, dtype=object)
        return self._wobj

    def _pack(self, n: int):
        pk = self._packs.get(n)
        if pk is None:
            z = np.zeros(0)
            return (np.zeros((0, n), np.uint32), z, z, z.astype(bool))
        return pk

    def _lazy(self, key: str, make):
        d = self.__dict__.get(key)
        if d is None:
            d = self.__dict__[key] = make()
        return d

    @property
    def unigrams(self):
        def make():
            ids, p, bo, _hb = self._pack(1)
            ws = self._words_obj()
            return dict(zip(ws[ids[:, 0]].tolist(),
                            zip(p.tolist(), bo.tolist())))
        return self._lazy("_d_uni", make)

    @unigrams.setter
    def unigrams(self, v):
        self.__dict__["_d_uni"] = v

    @property
    def bigrams(self):
        def make():
            ids, p, bo, _hb = self._pack(2)
            ws = self._words_obj()
            keys = zip(ws[ids[:, 0]].tolist(), ws[ids[:, 1]].tolist())
            return dict(zip(keys, zip(p.tolist(), bo.tolist())))
        return self._lazy("_d_bi", make)

    @bigrams.setter
    def bigrams(self, v):
        self.__dict__["_d_bi"] = v

    @property
    def trigrams(self):
        def make():
            ids, p, _bo, _hb = self._pack(3)
            ws = self._words_obj()
            keys = zip(ws[ids[:, 0]].tolist(), ws[ids[:, 1]].tolist(),
                       ws[ids[:, 2]].tolist())
            return dict(zip(keys, p.tolist()))
        return self._lazy("_d_tri", make)

    @trigrams.setter
    def trigrams(self, v):
        self.__dict__["_d_tri"] = v

    @property
    def tri_bo(self):
        def make():
            ids, _p, bo, hb = self._pack(3)
            if not hb.any():
                return {}
            ids, bo = ids[hb], bo[hb]
            ws = self._words_obj()
            keys = zip(ws[ids[:, 0]].tolist(), ws[ids[:, 1]].tolist(),
                       ws[ids[:, 2]].tolist())
            return dict(zip(keys, bo.tolist()))
        return self._lazy("_d_tribo", make)

    @tri_bo.setter
    def tri_bo(self, v):
        self.__dict__["_d_tribo"] = v

    @property
    def fourgrams(self):
        def make():
            ids, p, _bo, _hb = self._pack(4)
            ws = self._words_obj()
            keys = zip(ws[ids[:, 0]].tolist(), ws[ids[:, 1]].tolist(),
                       ws[ids[:, 2]].tolist(), ws[ids[:, 3]].tolist())
            return dict(zip(keys, p.tolist()))
        return self._lazy("_d_four", make)

    @fourgrams.setter
    def fourgrams(self, v):
        self.__dict__["_d_four"] = v

    # -- vectorised access ---------------------------------------------
    def _word_map(self, words, extra):
        if self._widx is None:
            self._widx = {w: k for k, w in enumerate(self._vocab_list)}
        m = np.full(len(self._vocab_list) + 1, -1, np.int64)
        for k, w in enumerate(list(words) + list(extra)):
            vid = self._widx.get(w)
            if vid is not None:
                m[vid] = k
        return m

    def bigram_arrays(self, words: List[str], extra: Tuple[str, ...] = ()):
        if "_d_bi" in self.__dict__:
            # dicts were touched (possibly edited): they are the truth
            return super().bigram_arrays(words, extra)
        m = self._word_map(words, extra)
        ids, p, _bo, _hb = self._pack(2)
        if not len(ids):
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.float64))
        i = m[ids[:, 0].astype(np.int64)]
        j = m[ids[:, 1].astype(np.int64)]
        keep = (i >= 0) & (j >= 0)
        return i[keep], j[keep], p[keep]

    def bigram_bow_arrays(self, words: List[str], extra: Tuple[str, ...] = ()):
        if "_d_bi" in self.__dict__:
            return super().bigram_bow_arrays(words, extra)
        m = self._word_map(words, extra)
        ids, _p, bo, _hb = self._pack(2)
        if not len(ids):
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.float64))
        i = m[ids[:, 0].astype(np.int64)]
        j = m[ids[:, 1].astype(np.int64)]
        keep = (i >= 0) & (j >= 0)
        return i[keep], j[keep], bo[keep]

    def trigram_arrays(self, words: List[str], extra: Tuple[str, ...] = ()):
        if "_d_tri" in self.__dict__:
            return super().trigram_arrays(words, extra)
        m = self._word_map(words, extra)
        ids, p, _bo, _hb = self._pack(3)
        if not len(ids):
            z = np.zeros(0, np.int64)
            return z, z.copy(), z.copy(), np.zeros(0, np.float64)
        i = m[ids[:, 0].astype(np.int64)]
        j = m[ids[:, 1].astype(np.int64)]
        k = m[ids[:, 2].astype(np.int64)]
        keep = (i >= 0) & (j >= 0) & (k >= 0)
        return i[keep], j[keep], k[keep], p[keep]


def _num_factory(line, path):
    def num(tok):
        try:
            return float(tok) * LN10
        except ValueError:
            HError(8154, "ReadLModel: bad number '%s' in n-gram "
                         "line '%s' of %s", tok, line, path)
    return num


def read_arpa(path: str, cfg=None) -> NGramLM:
    from ..utils.filters import filtered

    try:
        with filtered(path, "HLANGMODFILTER", cfg) as p:
            lines = open(p, "r", errors="replace").read().splitlines()
    except OSError as e:
        HError(8110, "ReadLModel: cannot open LM %s (%s)", path, e)
    lm = NGramLM()
    section = 0
    for raw in lines:
        line = raw.strip()
        if not line:
            continue
        if line.startswith("\\data\\"):
            section = -1
            continue
        if line.startswith("\\1-grams"):
            section = 1
            continue
        if line.startswith("\\2-grams"):
            section = 2
            lm.order = max(lm.order, 2)
            continue
        if line.startswith("\\3-grams"):
            section = 3
            lm.order = max(lm.order, 3)
            continue
        if line.startswith("\\4-grams"):
            section = 4
            lm.order = 4
            continue
        if line.startswith("\\end\\"):
            break
        if section != 0 and line.startswith("\\") and "-grams" in line:
            # \5-grams: (or higher) — refuse rather than misparse the
            # section's lines under the previous order
            HError(8153, "ReadLModel: unsupported n-gram section '%s' "
                         "in %s (max order 4)", line, path)
        if section <= 0:
            continue
        parts = line.split()
        num = _num_factory(line, path)
        if section == 1 and len(parts) >= 2:
            p = num(parts[0])
            w = parts[1]
            bo = num(parts[2]) if len(parts) > 2 else 0.0
            lm.unigrams[w] = (p, bo)
        elif section == 2 and len(parts) >= 3:
            p = num(parts[0])
            bo = num(parts[3]) if len(parts) > 3 else 0.0
            lm.bigrams[(parts[1], parts[2])] = (p, bo)
        elif section == 3 and len(parts) >= 4:
            lm.trigrams[(parts[1], parts[2], parts[3])] = num(parts[0])
            if len(parts) > 4:
                lm.tri_bo[(parts[1], parts[2], parts[3])] = num(parts[4])
        elif section == 4 and len(parts) >= 5:
            lm.fourgrams[(parts[1], parts[2], parts[3], parts[4])] = (
                num(parts[0]))
    if not lm.unigrams:
        HError(8150, "ReadLModel: no unigrams found in %s", path)
    return lm


def write_matrix_bigram(lm: NGramLM, words: List[str], path: str) -> None:
    """Matrix bigram file (HLM.c MatBigram; HLStats' default -b output).

    One row per word in `words` order: the row word followed by
    P(col | row) for every column word in the same order, wrapped 8
    numbers per line with continuation lines indented. [LC layout vs
    reference: HTKBook documents the matrix-vs-backoff distinction; the
    exact wrap width is unverifiable until the mount appears.]
    """
    with open(path, "w") as f:
        for w1 in words:
            probs = [math.exp(lm.logp_bi(w1, w2)) for w2 in words]
            # renormalise rows (counts floored/discounted upstream)
            tot = sum(probs)
            if tot > 0:
                probs = [p / tot for p in probs]
            f.write(f"{w1:<12s}")
            for k, p in enumerate(probs):
                if k and k % 8 == 0:
                    f.write("\n" + " " * 12)
                f.write(f" {p:.4e}")
            f.write("\n")


def read_matrix_bigram(path: str, words: Optional[List[str]] = None,
                       cfg=None) -> NGramLM:
    """Read a matrix bigram file back into an NGramLM (explicit bigrams
    only; no back-off weights — the matrix is dense by construction)."""
    from ..utils.filters import filtered

    rows: List[Tuple[str, List[float]]] = []
    cur: Optional[Tuple[str, List[float]]] = None
    with filtered(path, "HLANGMODFILTER", cfg) as p:
        lines = list(open(p, errors="replace"))
    with contained(8155, "read_matrix_bigram", path):
        for raw in lines:
            if not raw.strip():
                continue
            if raw[0] not in (" ", "\t"):
                if cur is not None:
                    rows.append(cur)
                parts = raw.split()
                cur = (parts[0], [float(x) for x in parts[1:]])
            else:
                if cur is None:
                    HError(8155, "read_matrix_bigram: continuation line "
                                 "before any row in %s", path)
                cur[1].extend(float(x) for x in raw.split())
    if cur is not None:
        rows.append(cur)
    order = words if words is not None else [w for w, _ in rows]
    if any(len(ps) != len(order) for _w, ps in rows):
        HError(8151, "read_matrix_bigram: row width != vocabulary size "
                     "in %s", path)
    lm = NGramLM(order=2)
    n = max(len(order), 1)
    for w, _ps in rows:
        lm.unigrams[w] = (math.log(1.0 / n), 0.0)
    for w, ps in rows:
        for w2, p in zip(order, ps):
            if p > 0.0:
                lm.bigrams[(w, w2)] = (math.log(p), 0.0)
    return lm


BINLM_MAGIC = b"!BINLM\n"
BINLM_VERSION = 1


def write_binary_lm(lm: NGramLM, path: str) -> None:
    """HTK binary n-gram LM (`HTKLib/HLM.c : WriteLModel` binary form,
    SURVEY.md §2.1 HLM row).

    [LC: reconstructed — the reference mount is empty, so the byte
    layout is this framework's own, marked by an explicit magic so a
    real HTK binary LM is rejected with a numbered error rather than
    misparsed.] Layout: `!BINLM\\n` magic, one text header line
    `version order n1 [n2 [n3 [n4]]]\\n`, the vocabulary as
    newline-terminated UTF-8 words, then big-endian binary sections per
    order: uint32 word ids (header order) and f32 natural-log prob
    (+ f32 back-off weight for orders < max). Write->read->write is
    byte-identical (tested)."""
    import struct

    words = sorted(lm.unigrams)
    wid = {w: i for i, w in enumerate(words)}
    counts = [len(lm.unigrams), len(lm.bigrams), len(lm.trigrams),
              len(lm.fourgrams)]
    order = max(k + 1 for k, c in enumerate(counts) if c or k == 0)
    with open(path, "wb") as f:
        f.write(BINLM_MAGIC)
        hdr = " ".join(
            [str(BINLM_VERSION), str(order)]
            + [str(c) for c in counts[:order]])
        f.write(hdr.encode() + b"\n")
        for w in words:
            f.write(w.encode() + b"\n")
        for w in words:
            p, bo = lm.unigrams[w]
            f.write(struct.pack(">ff", p, bo))
        for (w1, w2), (p, bo) in sorted(lm.bigrams.items()):
            f.write(struct.pack(">IIff", wid[w1], wid[w2], p, bo))
        for (w1, w2, w3), p in sorted(lm.trigrams.items()):
            bo = lm.tri_bo.get((w1, w2, w3), 0.0)
            if order > 3:
                f.write(struct.pack(">IIIff", wid[w1], wid[w2], wid[w3],
                                    p, bo))
            else:
                f.write(struct.pack(">IIIf", wid[w1], wid[w2], wid[w3], p))
        for (w1, w2, w3, w4), p in sorted(lm.fourgrams.items()):
            f.write(struct.pack(">IIIIf", wid[w1], wid[w2], wid[w3],
                                wid[w4], p))


def read_binary_lm(path: str, cfg=None) -> NGramLM:
    """Read the binary n-gram LM written by write_binary_lm.

    Raises a numbered error on a bad magic or an unsupported version —
    `HTKLib/HLM.c : ReadLModel` rejects incompatible binary headers the
    same way."""
    from ..utils.filters import filtered

    with filtered(path, "HLANGMODFILTER", cfg) as p:
        data = open(p, "rb").read()
    if not data.startswith(BINLM_MAGIC):
        HError(8150, "ReadLModel: %s is not a binary n-gram LM", path)
    with contained(8151, "ReadLModel", path):
        return _parse_binary_lm(data, path)


def _parse_binary_lm(data: bytes, path: str) -> NGramLM:
    pos = len(BINLM_MAGIC)
    nl = data.index(b"\n", pos)
    hdr = data[pos:nl].decode().split()
    pos = nl + 1
    version = int(hdr[0])
    if version != BINLM_VERSION:
        HError(8152, "ReadLModel: binary LM version %d unsupported "
                     "(expected %d)", version, BINLM_VERSION)
    order = int(hdr[1])
    counts = [int(x) for x in hdr[2:2 + order]] + [0] * (4 - order)
    words = []
    for _ in range(counts[0]):
        nl = data.index(b"\n", pos)
        words.append(data[pos:nl].decode())
        pos = nl + 1

    # fixed-stride big-endian sections: decoded as whole numpy arrays
    # into the packed form (10^6-gram LMs load in milliseconds; the
    # materialised dicts are built lazily and match the former
    # struct-loop reader exactly — same f32->f64 widening)
    def take(dt, count):
        nonlocal pos
        arr = np.frombuffer(data, dtype=np.dtype(dt), count=count,
                            offset=pos)
        pos += arr.dtype.itemsize * count
        return arr

    packs: dict = {"order": order, "vocab": words}
    uni = take([("p", ">f4"), ("b", ">f4")], counts[0])
    packs[1] = (np.arange(counts[0], dtype=np.uint32)[:, None],
                uni["p"].astype(np.float64), uni["b"].astype(np.float64),
                uni["b"] != 0.0)
    if counts[1]:
        bi = take([("i", ">u4"), ("j", ">u4"), ("p", ">f4"), ("b", ">f4")],
                  counts[1])
        packs[2] = (np.stack([bi["i"], bi["j"]], 1).astype(np.uint32),
                    bi["p"].astype(np.float64), bi["b"].astype(np.float64),
                    bi["b"] != 0.0)
    if counts[2]:
        if order > 3:
            tri = take([("i", ">u4"), ("j", ">u4"), ("k", ">u4"),
                        ("p", ">f4"), ("b", ">f4")], counts[2])
            tb = tri["b"].astype(np.float64)
        else:
            tri = take([("i", ">u4"), ("j", ">u4"), ("k", ">u4"),
                        ("p", ">f4")], counts[2])
            tb = np.zeros(counts[2], np.float64)
        packs[3] = (np.stack([tri["i"], tri["j"], tri["k"]], 1)
                    .astype(np.uint32),
                    tri["p"].astype(np.float64), tb, tb != 0.0)
    if counts[3]:
        fo = take([("i", ">u4"), ("j", ">u4"), ("k", ">u4"), ("l", ">u4"),
                   ("p", ">f4")], counts[3])
        packs[4] = (np.stack([fo["i"], fo["j"], fo["k"], fo["l"]], 1)
                    .astype(np.uint32),
                    fo["p"].astype(np.float64),
                    np.zeros(counts[3], np.float64),
                    np.zeros(counts[3], bool))
    if pos != len(data):
        HError(8151, "ReadLModel: %d trailing bytes in binary LM %s",
               len(data) - pos, path)
    lm = PackedNGramLM(packs)
    lm.order = order
    return lm


def read_lm(path: str, cfg=None,
            words: Optional[List[str]] = None) -> NGramLM:
    """Open an n-gram LM of any supported container: binary
    (write_binary_lm magic), ARPA back-off, or matrix bigram — sniffed
    from the leading bytes like HLM.c/HBuild do."""
    from ..utils.filters import filtered

    with filtered(path, "HLANGMODFILTER", cfg) as p:
        head = open(p, "rb").read(4096)
    if head.startswith(BINLM_MAGIC):
        return read_binary_lm(path, cfg)
    if b"\\data\\" in head:
        return read_arpa(path, cfg)
    return read_matrix_bigram(path, words=words, cfg=cfg)


def save_lm(lm: NGramLM, path: str, cfg=None) -> None:
    """Write an LM in the configured container: `HLM: SAVEBINARY = T`
    selects the binary form (the HLMTools binary-output switch), ARPA
    otherwise."""
    if cfg is not None and cfg.bool_("SAVEBINARY", False, module="HLM"):
        write_binary_lm(lm, path)
    else:
        write_arpa(lm, path)


def write_arpa(lm: NGramLM, path: str) -> None:
    with open(path, "w") as f:
        f.write("\\data\\\n")
        f.write(f"ngram 1={len(lm.unigrams)}\n")
        if lm.bigrams:
            f.write(f"ngram 2={len(lm.bigrams)}\n")
        if lm.trigrams:
            f.write(f"ngram 3={len(lm.trigrams)}\n")
        if lm.fourgrams:
            f.write(f"ngram 4={len(lm.fourgrams)}\n")
        f.write("\n\\1-grams:\n")
        for w, (p, bo) in sorted(lm.unigrams.items()):
            if bo != 0.0:
                f.write(f"{p / LN10:.4f} {w} {bo / LN10:.4f}\n")
            else:
                f.write(f"{p / LN10:.4f} {w}\n")
        if lm.bigrams:
            f.write("\n\\2-grams:\n")
            for (w1, w2), (p, bo) in sorted(lm.bigrams.items()):
                if bo != 0.0:
                    f.write(f"{p / LN10:.4f} {w1} {w2} {bo / LN10:.4f}\n")
                else:
                    f.write(f"{p / LN10:.4f} {w1} {w2}\n")
        if lm.trigrams:
            f.write("\n\\3-grams:\n")
            for (w1, w2, w3), p in sorted(lm.trigrams.items()):
                bo = lm.tri_bo.get((w1, w2, w3))
                if bo:
                    f.write(f"{p / LN10:.4f} {w1} {w2} {w3} {bo / LN10:.4f}\n")
                else:
                    f.write(f"{p / LN10:.4f} {w1} {w2} {w3}\n")
        if lm.fourgrams:
            f.write("\n\\4-grams:\n")
            for (w1, w2, w3, w4), p in sorted(lm.fourgrams.items()):
                f.write(f"{p / LN10:.4f} {w1} {w2} {w3} {w4}\n")
        f.write("\n\\end\\\n")
