"""MMF (Master Macro File) reader/writer — HTK HMM definitions.

Mirrors `HTKLib/HModel.c : LoadHMMSet()/SaveHMMSet()` text format:

  ~o <STREAMINFO> 1 39 <VECSIZE> 39 <MFCC_E_D_A> <DIAGC>
  ~v "varFloor1"  <VARIANCE> 39  ...
  ~h "ax" <BEGINHMM> <NUMSTATES> 5
    <STATE> 2 <NUMMIXES> 6 <MIXTURE> 1 0.5 <MEAN> 39 ... <VARIANCE> 39 ...
    <TRANSP> 5 ... <ENDHMM>

Parameter tying is expressed by macros: a definition site (`~s "name"`
followed by a body) registers the object; a use site (`~s "name"` where a
body is expected) references it. Sharing is represented here by Python
object identity — the same StateInfo/MixPDF/etc. object appears in every
HMM that ties it, exactly like HTK's pointer sharing.

Macro types supported: ~o options, ~h hmm, ~s state, ~m mixpdf, ~u mean,
~v variance, ~i invcovar, ~t transP, ~w stream weights, ~d duration.
(Adaptation macros ~r/~a/~b/~j and ANN macros ~L/~N/~F are handled by
their own modules.)

Binary MMFs (HTK's -B flag) use the ':'-code form: ASCII macro headers,
keywords as ':' + Symbol-enum byte, counts as big-endian int16, values
as big-endian float32 (HModel.c PutSymbol/GetToken/WriteVector). One
tokenizer serves both forms, binary-ness decided per keyword token just
like HModel.c's binForm flag. [LC: exact symbol codes reconstructed from
canonical HTK 3.4.1; byte-check against the reference when it appears.]

Copied from `htk_tpu/io/mmf.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, TextIO, Tuple

import numpy as np

from ..utils.errors import HError, contained
from . import parmkind as pk

LZERO = -1.0e10
MINMIX = 1e-5  # HTK MINMIX: mixture weights below this are defunct

COV_KINDS = ("DIAGC", "INVDIAGC", "FULLC", "LLTC", "XFORMC")
DUR_KINDS = ("NULLD", "POISSOND", "GAMMAD", "GEND")


@dataclass
class MixPDF:
    """A single Gaussian component (HModel.c MixPDF)."""

    mean: np.ndarray  # (D,)
    var: np.ndarray  # (D,) diagonal variance (or inverse-cov matrix for FULLC)
    gconst: Optional[float] = None
    cov_kind: str = "DIAGC"

    def fix_gconst(self) -> float:
        """gConst = D*log(2pi) + sum(log var) (HModel.c : FixGConsts)."""
        d = len(self.mean)
        if self.cov_kind == "DIAGC":
            self.gconst = float(d * math.log(2 * math.pi) + np.sum(np.log(self.var)))
        elif self.cov_kind == "FULLC":
            # var holds the inverse covariance (upper-tri stored full here)
            sign, logdet = np.linalg.slogdet(self.var)
            self.gconst = float(d * math.log(2 * math.pi) - logdet)
        elif self.cov_kind == "LLTC":
            # var holds the LLT factor of the precision: log|P| =
            # 2 sum log diag(L) [LC]
            diag = np.maximum(np.abs(np.diag(self.var)), 1e-38)
            self.gconst = float(d * math.log(2 * math.pi)
                                - 2.0 * np.sum(np.log(diag)))
        else:
            HError(7032, "fix_gconst: covariance kind %s unsupported", self.cov_kind)
        return self.gconst


@dataclass
class StreamElem:
    """Mixture list for one stream (HModel.c StreamElem).

    Discrete streams store a DProb codeword table instead of Gaussians:
    dprobs[k] is HTK's short-coded -2371.8*ln(p) value for codeword k+1
    (32767 = floored zero).
    """

    weights: List[float] = field(default_factory=list)
    mixes: List[Optional[MixPDF]] = field(default_factory=list)
    dprobs: Optional[np.ndarray] = None  # (K,) int16-coded probs
    # TIEDHS: shared-pool base name; mixes are the ~m macros base1..baseM
    tmix_base: Optional[str] = None

DPROB_SCALE = -2371.8


def dprob_to_logp(d: np.ndarray) -> np.ndarray:
    """Short-coded DProb -> natural log prob (HModel.c DProb2Short inv)."""
    lp = np.asarray(d, np.float64) / DPROB_SCALE
    return np.where(np.asarray(d) >= 32767, LZERO, lp).astype(np.float32)


def logp_to_dprob(lp: np.ndarray) -> np.ndarray:
    """Natural log prob -> short-coded DProb."""
    d = np.round(np.asarray(lp, np.float64) * DPROB_SCALE)
    return np.clip(np.where(np.asarray(lp) <= LZERO / 2, 32767, d),
                   0, 32767).astype(np.int32)


@dataclass
class StateInfo:
    """Emitting-state definition (HModel.c StateInfo)."""

    streams: List[StreamElem] = field(default_factory=list)
    stream_weights: Optional[np.ndarray] = None
    dur: Optional[np.ndarray] = None


@dataclass
class HMMDef:
    """One HMM (HModel.c HMMDef): states 2..N-1 emit, transP is (N, N)."""

    name: str
    nstates: int = 0
    states: List[StateInfo] = field(default_factory=list)  # len N-2
    transp: Optional[np.ndarray] = None  # (N, N) probs (not logs) in file
    dur: Optional[np.ndarray] = None  # model-level <DURATION> vector


@dataclass
class HMMSet:
    """A set of HMM definitions + macro tables (HModel.c HMMSet)."""

    vec_size: int = 0
    parm_kind: int = 0
    cov_kind: str = "DIAGC"
    dur_kind: str = "NULLD"
    stream_widths: List[int] = field(default_factory=list)
    hmms: Dict[str, HMMDef] = field(default_factory=dict)
    # macro tables: name -> object (definition sites)
    macros: Dict[str, Dict[str, object]] = field(
        default_factory=lambda: {k: {} for k in "hsmuvitwd"}
    )
    hmm_set_id: Optional[str] = None
    # ~a input transform attached by HHEd XF (HModel.c <INPUTXFORM>):
    # the TMF text, embedded verbatim in the MMF and applied by tools
    # run with -k
    input_xform: Optional[str] = None

    @property
    def parm_kind_str(self) -> str:
        return pk.parmkind2str(self.parm_kind)

    @property
    def swidth(self) -> List[int]:
        return self.stream_widths or [self.vec_size]

    def phys_hmm(self, name: str) -> HMMDef:
        h = self.hmms.get(name)
        if h is None:
            HError(7035, "HMMSet: no HMM named %s", name)
        return h


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

# HTK binary MMFs (HModel.c : PutSymbol/GetToken) interleave ASCII macro
# headers (~h "name") with binary keyword tokens: a ':' byte followed by
# one byte holding the Symbol enum value, after which counts are raw
# big-endian int16 and values raw big-endian float32. The symbol codes
# below follow HModel.c's Symbol enum (0-30 core block; adaptation block
# from 90; PARMKIND=120) with each symbol's TEXT keyword name, so one
# parser serves both forms. [LC: byte parity unverifiable while the
# reference mount is empty — codes reconstructed from canonical HTK 3.4.1.]
_SYM2KW = {
    0: "BEGINHMM", 1: "USEMAC", 2: "ENDHMM", 3: "NUMMIXES",
    4: "NUMSTATES", 5: "STREAMINFO", 6: "VECSIZE",
    7: "NULLD", 8: "POISSOND", 9: "GAMMAD", 10: "RELD", 11: "GEND",
    12: "DIAGC", 13: "FULLC", 14: "XFORMC", 15: "STATE",
    16: "TMIX", 17: "MIXTURE", 18: "STREAM", 19: "SWEIGHTS",
    20: "MEAN", 21: "VARIANCE", 22: "INVCOVAR", 23: "XFORM",
    24: "GCONST", 25: "DURATION", 26: "INVDIAGC", 27: "TRANSP",
    28: "DPROB", 29: "LLTC", 30: "LLTCOVAR",
    90: "XFORMKIND", 91: "PARENTXFORM", 92: "NUMXFORMS", 93: "XFORMSET",
    94: "LINXFORM", 95: "OFFSET", 96: "BIAS", 97: "LOGDET",
    98: "BLOCKINFO", 99: "BLOCK", 100: "BASECLASS", 101: "CLASS",
    102: "XFORMWGTSET", 103: "CLASSXFORM", 104: "MMFIDMASK",
    105: "PARAMETERS", 106: "NUMCLASSES", 107: "ADAPTKIND",
    108: "PREQUAL", 109: "INPUTXFORM",
    110: "RCLASS", 111: "REGTREE", 112: "NODE", 113: "TNODE",
    119: "HMMSETID", 120: "PARMKIND", 121: "MACRO", 122: "EOFSYM",
    123: "NULLSYM",
}
_KW2SYM = {v: k for k, v in _SYM2KW.items()}

_WS = b" \t\r\n"


class _Tok:
    KW = "kw"
    MACRO = "macro"
    STR = "str"
    ATOM = "atom"

    def __init__(self, kind: str, val: str, binary: bool = False):
        self.kind = kind
        self.val = val
        self.binary = binary

    def __repr__(self):
        return f"{self.kind}:{self.val}" + ("[bin]" if self.binary else "")


class _Lexer:
    """Byte-stream tokenizer serving both text and ':'-code binary MMFs.

    Tokens are produced lazily because binary numeric payloads follow
    their keyword token as raw bytes — they must be consumed by the
    parser (read_short/read_floats), never tokenized.
    """

    def __init__(self, data: bytes):
        self.d = data
        self.p = 0

    def _skip_ws(self):
        d, n = self.d, len(self.d)
        while self.p < n and d[self.p] in _WS:
            self.p += 1

    def next_tok(self) -> Optional[_Tok]:
        self._skip_ws()
        d, n = self.d, len(self.d)
        if self.p >= n:
            return None
        c = d[self.p]
        if c == 0x3C:  # '<' text keyword
            end = d.find(b">", self.p + 1)
            if end < 0:
                HError(7050, "MMF parse: unterminated keyword")
            kw = d[self.p + 1 : end].decode("latin-1").strip().upper()
            self.p = end + 1
            return _Tok(_Tok.KW, kw)
        if c == 0x3A:  # ':' binary symbol
            if self.p + 1 >= n:
                HError(7050, "MMF parse: truncated binary symbol")
            sym = d[self.p + 1]
            self.p += 2
            if sym == 122:  # EOFSYM
                return None
            kw = _SYM2KW.get(sym)
            if kw is None:
                HError(7050, "MMF parse: unknown binary symbol %d", sym)
            if kw == "PARMKIND":
                # ':' 120 is followed by a binary short holding the kind
                # code; surface it as the text-form kind keyword
                kind = self.read_short()
                return _Tok(_Tok.KW, pk.parmkind2str(kind), binary=True)
            return _Tok(_Tok.KW, kw, binary=True)
        if c == 0x7E:  # '~' macro type
            if self.p + 1 >= n:
                HError(7050, "MMF parse: truncated macro marker")
            mac = chr(d[self.p + 1])
            self.p += 2
            return _Tok(_Tok.MACRO, mac)
        if c == 0x22:  # '"' quoted string
            end = d.find(b'"', self.p + 1)
            if end < 0:
                HError(7050, "MMF parse: unterminated string")
            s = d[self.p + 1 : end].decode("latin-1")
            self.p = end + 1
            return _Tok(_Tok.STR, s)
        # plain atom: runs to whitespace or a structural byte — HTK writes
        # keywords without surrounding whitespace (`<VECSIZE> 4<NULLD>...`)
        start = self.p
        while self.p < n and d[self.p] not in _WS and d[self.p] not in b'<~":':
            self.p += 1
        return _Tok(_Tok.ATOM, d[start : self.p].decode("latin-1"))

    # raw binary payload reads (big-endian, HTK's default write order)
    def read_short(self) -> int:
        v = int(np.frombuffer(self.d, dtype=">i2", count=1, offset=self.p)[0])
        self.p += 2
        return v

    def read_shorts(self, n: int) -> np.ndarray:
        v = np.frombuffer(self.d, dtype=">i2", count=n, offset=self.p)
        self.p += 2 * n
        return v.astype(np.int32)

    def read_float(self) -> float:
        v = float(np.frombuffer(self.d, dtype=">f4", count=1, offset=self.p)[0])
        self.p += 4
        return v

    def read_floats(self, n: int) -> np.ndarray:
        v = np.frombuffer(self.d, dtype=">f4", count=n, offset=self.p)
        self.p += 4 * n
        return v.astype(np.float32)


class _Parser:
    def __init__(self, data, hset: HMMSet):
        if isinstance(data, str):
            data = data.encode("latin-1")
        self.lex = _Lexer(data)
        self._ahead: Optional[_Tok] = None
        self.hset = hset
        # binary flag of the most recently consumed keyword: numeric
        # payloads directly follow their keyword, so this selects between
        # text atoms and raw big-endian reads (HModel.c token binForm)
        self.bin = False

    def peek(self) -> Optional[_Tok]:
        if self._ahead is None:
            self._ahead = self.lex.next_tok()
        return self._ahead

    def next(self) -> _Tok:
        t = self.peek()
        if t is None:
            HError(7050, "MMF parse: unexpected end of file")
        self._ahead = None
        if t.kind == _Tok.KW:
            self.bin = t.binary
        return t

    def expect_kw(self, kw: str) -> None:
        t = self.next()
        if t.kind != _Tok.KW or t.val != kw:
            HError(7050, "MMF parse: expected <%s>, got %r", kw, t)

    def next_int(self) -> int:
        if self.bin:
            return self.lex.read_short()
        t = self.next()
        try:
            return int(t.val)
        except ValueError:
            HError(7050, "MMF parse: expected integer, got %r", t)

    def next_float(self) -> float:
        if self.bin:
            return self.lex.read_float()
        t = self.next()
        try:
            return float(t.val)
        except ValueError:
            HError(7050, "MMF parse: expected float, got %r", t)

    def next_string(self) -> str:
        t = self.next()
        if t.kind not in (_Tok.STR, _Tok.ATOM):
            HError(7050, "MMF parse: expected string, got %r", t)
        return t.val

    def read_vector(self, n: int) -> np.ndarray:
        if self.bin:
            return self.lex.read_floats(n)
        return np.array([self.next_float() for _ in range(n)], dtype=np.float32)

    def read_matrix(self, r: int, c: int) -> np.ndarray:
        return self.read_vector(r * c).reshape(r, c)

    def read_trimat(self, n: int) -> np.ndarray:
        """Upper-triangular (row i has n-i entries) -> full symmetric."""
        M = np.zeros((n, n), dtype=np.float32)
        for i in range(n):
            row = self.read_vector(n - i)
            M[i, i:] = row
            M[i:, i] = row
        return M

    # -- global options (~o) --------------------------------------------

    def parse_options(self):
        hs = self.hset
        while True:
            t = self.peek()
            if t is None or t.kind == _Tok.MACRO:
                return
            if t.kind != _Tok.KW:
                return
            kw = t.val
            if kw == "STREAMINFO":
                self.next()
                s = self.next_int()
                hs.stream_widths = [self.next_int() for _ in range(s)]
            elif kw == "VECSIZE":
                self.next()
                hs.vec_size = self.next_int()
            elif kw == "HMMSETID":
                self.next()
                hs.hmm_set_id = self.next_string()
            elif kw == "MSDINFO":
                self.next()
                s = self.next_int()
                for _ in range(s):
                    self.next_int()
            elif kw in COV_KINDS:
                self.next()
                hs.cov_kind = kw
            elif kw in DUR_KINDS:
                self.next()
                hs.dur_kind = kw
            elif kw == "PARMKIND":
                self.next()
                hs.parm_kind = pk.str2parmkind(self.next_string())
            else:
                # a parameter-kind flag like <MFCC_E_D_A>
                try:
                    hs.parm_kind = pk.str2parmkind(kw)
                    self.next()
                except Exception:
                    return

    # -- shared-structure bodies ----------------------------------------

    def parse_mean(self) -> np.ndarray:
        self.expect_kw("MEAN")
        n = self.next_int()
        return self.read_vector(n)

    def parse_variance_body(self, kw_tok: _Tok) -> Tuple[str, np.ndarray]:
        kw = kw_tok.val
        if kw == "VARIANCE":
            n = self.next_int()
            return "DIAGC", self.read_vector(n)
        if kw == "INVCOVAR":
            n = self.next_int()
            return "FULLC", self.read_trimat(n)
        if kw == "LLTCOVAR":
            n = self.next_int()
            return "LLTC", self.read_trimat(n)
        HError(7050, "MMF parse: expected variance kind, got <%s>", kw)

    def parse_mixpdf(self) -> MixPDF:
        """<MEAN>.. <VARIANCE>.. [<GCONST> g] — or ~u/~v/~i macro refs."""
        mean = None
        var = None
        cov_kind = "DIAGC"
        gconst = None
        t = self.peek()
        # mean
        if t.kind == _Tok.MACRO and t.val == "u":
            self.next()
            mean = self._macro_ref("u")
        else:
            mean = self.parse_mean()
        # variance
        t = self.peek()
        if t.kind == _Tok.MACRO and t.val in ("v", "i"):
            mac = self.next().val
            obj = self._macro_ref(mac)
            var = obj
            cov_kind = "DIAGC" if mac == "v" else "FULLC"
        else:
            kw = self.next()
            cov_kind, var = self.parse_variance_body(kw)
        t = self.peek()
        if t is not None and t.kind == _Tok.KW and t.val == "GCONST":
            self.next()
            gconst = self.next_float()
        mp = MixPDF(mean=mean, var=var, gconst=gconst, cov_kind=cov_kind)
        if gconst is None:
            mp.fix_gconst()
        return mp

    def _macro_ref(self, mac: str):
        name = self.next_string()
        table = self.hset.macros.get(mac, {})
        if name not in table:
            HError(7035, "MMF parse: undefined macro ~%s \"%s\"", mac, name)
        return table[name]

    def parse_state(self) -> StateInfo:
        hs = self.hset
        nstreams = len(hs.swidth)
        si = StateInfo()
        nmix = [1] * nstreams
        t = self.peek()
        if t.kind == _Tok.KW and t.val == "NUMMIXES":
            self.next()
            nmix = [self.next_int() for _ in range(nstreams)]
        t = self.peek()
        if t.kind == _Tok.KW and t.val == "SWEIGHTS":
            self.next()
            n = self.next_int()
            si.stream_weights = self.read_vector(n)
        elif t.kind == _Tok.MACRO and t.val == "w":
            self.next()
            si.stream_weights = self._macro_ref("w")

        for s in range(nstreams):
            t = self.peek()
            if t is not None and t.kind == _Tok.KW and t.val == "STREAM":
                self.next()
                self.next_int()
            se = StreamElem()
            m = nmix[s]
            t = self.peek()
            if t is not None and t.kind == _Tok.KW and t.val == "TMIX":
                # tied-mixture stream: <TMix> base w1 w2 ... (text RLE
                # value*repeat); Gaussians are the ~m macros base{k}
                self.next()
                base = self.next_string()
                if self.bin:
                    ws = [float(x) for x in self.lex.read_floats(m)]
                else:
                    ws = []
                    while len(ws) < m:
                        tok = self.next()
                        if "*" in tok.val:
                            v, r = tok.val.split("*")
                            ws.extend([float(v)] * int(r))
                        else:
                            ws.append(float(tok.val))
                mixes: List[Optional[MixPDF]] = []
                for k in range(m):
                    mp = hs.macros["m"].get(f"{base}{k + 1}")
                    if mp is None:
                        HError(7035, "MMF parse: TMix macro %s%d undefined",
                               base, k + 1)
                    mixes.append(mp)
                se.weights = ws[:m]
                se.mixes = mixes
                se.tmix_base = base
                si.streams.append(se)
                continue
            if t is not None and t.kind == _Tok.KW and t.val == "DPROB":
                self.next()
                if self.bin:
                    # binary: m raw shorts, no run-length coding
                    se.dprobs = self.lex.read_shorts(m)
                    si.streams.append(se)
                    continue
                # text: m short-coded codeword probs with HTK's
                # value*repeat run-length syntax
                vals: List[int] = []
                while len(vals) < m:
                    tok = self.next()
                    if "*" in tok.val:
                        v, r = tok.val.split("*")
                        vals.extend([int(v)] * int(r))
                    else:
                        vals.append(int(tok.val))
                se.dprobs = np.asarray(vals[:m], np.int32)
                si.streams.append(se)
                continue
            if m == 1:
                t = self.peek()
                if t.kind == _Tok.MACRO and t.val == "m":
                    self.next()
                    mp = self._macro_ref("m")
                else:
                    mp = self.parse_mixpdf()
                se.weights = [1.0]
                se.mixes = [mp]
            else:
                se.weights = [0.0] * m
                se.mixes = [None] * m
                while True:
                    t = self.peek()
                    if t is None or t.kind != _Tok.KW or t.val != "MIXTURE":
                        break
                    self.next()
                    mi = self.next_int()
                    w = self.next_float()
                    t = self.peek()
                    if t.kind == _Tok.MACRO and t.val == "m":
                        self.next()
                        mp = self._macro_ref("m")
                    else:
                        mp = self.parse_mixpdf()
                    se.weights[mi - 1] = w
                    se.mixes[mi - 1] = mp
            si.streams.append(se)

        t = self.peek()
        if t is not None:
            if t.kind == _Tok.KW and t.val == "DURATION":
                self.next()
                n = self.next_int()
                si.dur = self.read_vector(n)
            elif t.kind == _Tok.MACRO and t.val == "d":
                self.next()
                si.dur = self._macro_ref("d")
        return si

    def parse_transp(self) -> np.ndarray:
        self.expect_kw("TRANSP")
        n = self.next_int()
        return self.read_matrix(n, n)

    def parse_hmm(self, name: str) -> HMMDef:
        h = HMMDef(name=name)
        self.expect_kw("BEGINHMM")
        self.expect_kw("NUMSTATES")
        h.nstates = self.next_int()
        for i in range(2, h.nstates):
            self.expect_kw("STATE")
            si_idx = self.next_int()
            if si_idx != i:
                HError(7050, "MMF parse: state index %d, expected %d", si_idx, i)
            t = self.peek()
            if t.kind == _Tok.MACRO and t.val == "s":
                self.next()
                h.states.append(self._macro_ref("s"))
            else:
                h.states.append(self.parse_state())
        t = self.peek()
        if t.kind == _Tok.MACRO and t.val == "t":
            self.next()
            h.transp = self._macro_ref("t")
        else:
            h.transp = self.parse_transp()
        t = self.peek()
        if t is not None and t.kind == _Tok.KW and t.val == "DURATION":
            self.next()
            n = self.next_int()
            h.dur = self.read_vector(n)
        elif t is not None and t.kind == _Tok.MACRO and t.val == "d":
            self.next()
            h.dur = self._macro_ref("d")
        self.expect_kw("ENDHMM")
        return h

    # -- top level -------------------------------------------------------

    def parse(self):
        hs = self.hset
        while True:
            t = self.peek()
            if t is None:
                return
            if t.kind != _Tok.MACRO:
                HError(7050, "MMF parse: expected macro, got %r", t)
            mac = self.next().val
            if mac == "o":
                self.parse_options()
            elif mac == "h":
                name = self.next_string()
                h = self.parse_hmm(name)
                hs.hmms[name] = h
                hs.macros["h"][name] = h
            elif mac == "s":
                name = self.next_string()
                hs.macros["s"][name] = self.parse_state()
            elif mac == "m":
                name = self.next_string()
                hs.macros["m"][name] = self.parse_mixpdf()
            elif mac == "u":
                name = self.next_string()
                hs.macros["u"][name] = self.parse_mean()
            elif mac == "v":
                name = self.next_string()
                kw = self.next()
                _, v = self.parse_variance_body(kw)
                hs.macros["v"][name] = v
            elif mac == "i":
                name = self.next_string()
                kw = self.next()
                _, v = self.parse_variance_body(kw)
                hs.macros["i"][name] = v
            elif mac == "t":
                name = self.next_string()
                hs.macros["t"][name] = self.parse_transp()
            elif mac == "w":
                name = self.next_string()
                self.expect_kw("SWEIGHTS")
                n = self.next_int()
                hs.macros["w"][name] = self.read_vector(n)
            elif mac == "d":
                name = self.next_string()
                self.expect_kw("DURATION")
                n = self.next_int()
                hs.macros["d"][name] = self.read_vector(n)
            elif mac == "a":
                # ~a input transform (HHEd XF): capture the raw TMF body
                # verbatim up to the next macro marker — the TMF grammar
                # is its own (algo/adapt.py), not MMF keywords
                name = self.next_string()
                d = self.lex.d
                q = d.find(b"~", self.lex.p)
                end = q if q >= 0 else len(d)
                body = d[self.lex.p:end].decode("latin-1")
                self.lex.p = end
                hs.input_xform = f'~a "{name}"\n' + body.strip() + "\n"
            else:
                HError(7050, "MMF parse: unsupported macro type ~%s", mac)


_OLD_PICKLE_MAGIC = b"#!HTK-TPU-BMMF!#"  # round-1 format, now rejected


def load_mmf(paths, hset: Optional[HMMSet] = None, cfg=None) -> HMMSet:
    """Load one or more MMF files into an HMMSet (HModel.c : LoadHMMSet).

    Text and ':'-code binary MMFs share one tokenizer; binary keywords
    are detected per token, exactly like HModel.c's GetToken, so mixed
    files also parse. The round-1 pickle format is rejected loudly
    (loading pickles from model files would execute arbitrary code).
    """
    if isinstance(paths, str):
        paths = [paths]
    hset = hset or HMMSet()
    from ..utils.filters import filtered

    for p in paths:
        try:
            with filtered(p, "HMMDEFFILTER", cfg) as fp:
                data = open(fp, "rb").read()
        except OSError as e:
            HError(7010, "load_mmf: cannot open %s (%s)", p, e)
        if data.startswith(_OLD_PICKLE_MAGIC):
            HError(
                7050,
                "load_mmf: %s is a round-1 pickle MMF; that format is no "
                "longer read (unsafe). Re-save it as text or ':'-code "
                "binary with save_mmf.", p,
            )
        with contained(7050, "load_mmf", p):
            _Parser(data, hset).parse()
    return hset


def load_hmm_list(path: str, cfg=None) -> List[Tuple[str, Optional[str]]]:
    """HMM list file: 'logical [physical]' per line (HModel.c LoadHMMList)."""
    from ..utils.filters import filtered

    out = []
    try:
        with filtered(path, "HMMLISTFILTER", cfg) as _p:
            lines_src = open(_p, errors="replace").read().splitlines()
    except FileNotFoundError:
        HError(2610, "LoadHMMList: cannot open hmm list %s", path)
    for ln in lines_src:
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        parts = ln.split()
        out.append((parts[0], parts[1] if len(parts) > 1 else None))
    return out


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _fmt_vec(v: np.ndarray) -> str:
    return " " + " ".join("%.6e" % x for x in np.asarray(v).reshape(-1))


class _Writer:
    """Text MMF writer. Leaf emissions go through the kw0/kwn/kwflt/
    kw_int_flt/vec/vec_nl/dprob primitives so _BinWriter can override
    just those and share the whole macro/tying traversal."""

    def __init__(self, hset: HMMSet, f):
        self.hset = hset
        self.f = f
        # object id -> (macro type, name), for emitting refs at use sites
        self.shared: Dict[int, Tuple[str, str]] = {}
        for mac, table in hset.macros.items():
            if mac == "h":
                continue
            for name, obj in table.items():
                self.shared[id(obj)] = (mac, name)

    def w(self, s: str):
        self.f.write(s)

    # -- leaf emission primitives (overridden by _BinWriter) -------------

    def kw0(self, name: str):
        self.w(f"<{name}>\n")

    def kwn(self, name: str, *ints: int):
        self.w(f"<{name}> " + " ".join(str(x) for x in ints) + "\n")

    def kwflt(self, name: str, x: float):
        self.w(f"<{name}> %.6e\n" % x)

    def kw_int_flt(self, name: str, i: int, x: float):
        self.w(f"<{name}> {i} %.6e\n" % x)

    def vec_nl(self, v):
        """A vector/matrix-row payload on its own line (text form)."""
        self.w(_fmt_vec(v) + "\n")

    def dprob(self, vals):
        # run-length encode consecutive repeats (HTK x*n form)
        out = []
        vals = [int(v) for v in vals]
        i = 0
        while i < len(vals):
            j = i
            while j + 1 < len(vals) and vals[j + 1] == vals[i]:
                j += 1
            out.append(f"{vals[i]}*{j - i + 1}" if j > i else str(vals[i]))
            i = j + 1
        self.w("<DPROB> " + " ".join(out) + "\n")

    def tmix(self, base: str, weights):
        # run-length encode equal consecutive weights (HTK w*n form)
        out = []
        ws = ["%.6e" % w for w in weights]
        i = 0
        while i < len(ws):
            j = i
            while j + 1 < len(ws) and ws[j + 1] == ws[i]:
                j += 1
            out.append(f"{ws[i]}*{j - i + 1}" if j > i else ws[i])
            i = j + 1
        self.w(f"<TMIX> {base} " + " ".join(out) + "\n")

    def write_options(self):
        hs = self.hset
        self.w("~o\n")
        if hs.hmm_set_id:
            self.w(f"<HMMSETID> {hs.hmm_set_id}\n")
        sw = hs.swidth
        self.w(f"<STREAMINFO> {len(sw)} " + " ".join(str(x) for x in sw) + "\n")
        self.w(
            f"<VECSIZE> {hs.vec_size}<{hs.dur_kind}><{hs.parm_kind_str}><{hs.cov_kind}>\n"
        )

    def end_macro(self):
        """Separator after each top-level macro body (binary adds '\\n')."""

    # -- structure (shared between text and binary) ----------------------

    def write_mean(self, mean):
        ref = self.shared.get(id(mean))
        if ref and ref[0] == "u":
            self.w(f'~u "{ref[1]}"\n')
        else:
            self._write_mean_body(mean)

    def _write_mean_body(self, mean):
        self.kwn("MEAN", len(mean))
        self.vec_nl(mean)

    def write_var(self, var, cov_kind):
        ref = self.shared.get(id(var))
        if ref and ref[0] in ("v", "i"):
            self.w(f'~{ref[0]} "{ref[1]}"\n')
            return
        self._write_var_body(var, cov_kind)

    def _write_var_body(self, var, cov_kind):
        if cov_kind == "DIAGC":
            self.kwn("VARIANCE", len(var))
            self.vec_nl(var)
        elif cov_kind in ("FULLC", "LLTC"):
            kw = "INVCOVAR" if cov_kind == "FULLC" else "LLTCOVAR"
            n = var.shape[0]
            self.kwn(kw, n)
            for i in range(n):
                self.vec_nl(var[i, i:])
        else:
            HError(7032, "write_var: unsupported cov kind %s", cov_kind)

    def write_mixpdf(self, mp: MixPDF):
        ref = self.shared.get(id(mp))
        if ref and ref[0] == "m":
            self.w(f'~m "{ref[1]}"\n')
            return
        self._write_mixpdf_body(mp)

    def _write_mixpdf_body(self, mp: MixPDF):
        self.write_mean(mp.mean)
        self.write_var(mp.var, mp.cov_kind)
        if mp.gconst is not None:
            self.kwflt("GCONST", mp.gconst)

    def _write_state_body(self, si: StateInfo):
        hs = self.hset
        nstreams = len(hs.swidth)
        nmix = [
            (len(se.dprobs) if se.dprobs is not None else len(se.mixes))
            for se in si.streams
        ]
        if any(m > 1 for m in nmix):
            self.kwn("NUMMIXES", *nmix)
        if si.stream_weights is not None:
            ref = self.shared.get(id(si.stream_weights))
            if ref and ref[0] == "w":
                self.w(f'~w "{ref[1]}"\n')
            else:
                self.kwn("SWEIGHTS", len(si.stream_weights))
                self.vec_nl(si.stream_weights)
        for s, se in enumerate(si.streams):
            if nstreams > 1:
                self.kwn("STREAM", s + 1)
            if se.dprobs is not None:
                self.dprob(se.dprobs)
                continue
            if se.tmix_base:
                self.tmix(se.tmix_base, se.weights)
                continue
            if len(se.mixes) == 1:
                self.write_mixpdf(se.mixes[0])
            else:
                for mi, (wt, mp) in enumerate(zip(se.weights, se.mixes)):
                    if mp is None or wt < MINMIX:
                        continue
                    self.kw_int_flt("MIXTURE", mi + 1, wt)
                    self.write_mixpdf(mp)
        if si.dur is not None:
            self.kwn("DURATION", len(si.dur))
            self.vec_nl(si.dur)

    def write_state(self, si: StateInfo):
        ref = self.shared.get(id(si))
        if ref and ref[0] == "s":
            self.w(f'~s "{ref[1]}"\n')
            return
        self._write_state_body(si)

    def _write_transp_body(self, tp: np.ndarray):
        n = tp.shape[0]
        self.kwn("TRANSP", n)
        for i in range(n):
            self.vec_nl(tp[i])

    def write_transp(self, tp: np.ndarray):
        ref = self.shared.get(id(tp))
        if ref and ref[0] == "t":
            self.w(f'~t "{ref[1]}"\n')
            return
        self._write_transp_body(tp)

    def write_hmm(self, h: HMMDef):
        self.kw0("BEGINHMM")
        self.kwn("NUMSTATES", h.nstates)
        for i, si in enumerate(h.states):
            self.kwn("STATE", i + 2)
            self.write_state(si)
        self.write_transp(h.transp)
        if h.dur is not None:
            ref = self.shared.get(id(h.dur))
            if ref and ref[0] == "d":
                self.w(f'~d "{ref[1]}"\n')
            else:
                self.kwn("DURATION", len(h.dur))
                self.vec_nl(h.dur)
        self.kw0("ENDHMM")

    def write_all(self):
        hs = self.hset
        self.write_options()
        self.end_macro()
        if hs.input_xform:
            # text TMF block in both text and binary MMFs (HTK binary
            # MMFs interleave text macro headers the same way)
            self.w(hs.input_xform)
            self.end_macro()
        # shared macro definitions first, in HTK's conventional order
        for mac in ("u", "v", "i", "w", "d", "m", "t", "s"):
            for name, obj in hs.macros.get(mac, {}).items():
                self.w(f'~{mac} "{name}"\n')
                if mac == "m":
                    self._write_mixpdf_body(obj)
                elif mac == "s":
                    self._write_state_body(obj)
                elif mac == "t":
                    self._write_transp_body(obj)
                elif mac == "u":
                    self._write_mean_body(obj)
                elif mac == "v":
                    self._write_var_body(obj, "DIAGC")
                elif mac == "i":
                    self._write_var_body(obj, "FULLC")
                elif mac == "w":
                    self.kwn("SWEIGHTS", len(obj))
                    self.vec_nl(obj)
                elif mac == "d":
                    self.kwn("DURATION", len(obj))
                    self.vec_nl(obj)
                self.end_macro()
        for name, h in hs.hmms.items():
            self.w(f'~h "{name}"\n')
            self.write_hmm(h)
            self.end_macro()


class _BinWriter(_Writer):
    """':'-code binary MMF writer (HModel.c : SaveHMMSet binary mode).

    Macro headers stay ASCII (`~s "name"`); keywords become ':' + the
    Symbol code byte; counts are raw big-endian int16 and values raw
    big-endian float32 — HTK's PutSymbol/WriteShort/WriteVector layout.
    [LC: byte parity pending a populated reference mount.]
    """

    def _sym(self, name: str):
        self.w(":" + chr(_KW2SYM[name]))

    def _short(self, x: int):
        self.f.write_bytes(np.asarray([x], ">i2").tobytes())

    def _flt(self, x: float):
        self.f.write_bytes(np.asarray([x], ">f4").tobytes())

    def kw0(self, name: str):
        self._sym(name)

    def kwn(self, name: str, *ints: int):
        self._sym(name)
        for x in ints:
            self._short(x)

    def kwflt(self, name: str, x: float):
        self._sym(name)
        self._flt(x)

    def kw_int_flt(self, name: str, i: int, x: float):
        self._sym(name)
        self._short(i)
        self._flt(x)

    def vec_nl(self, v):
        self.f.write_bytes(
            np.asarray(v, np.float32).reshape(-1).astype(">f4").tobytes())

    def dprob(self, vals):
        self._sym("DPROB")
        self.f.write_bytes(np.asarray(vals, ">i2").tobytes())

    def tmix(self, base: str, weights):
        # symbol + text base name (macro-header style) + raw weights;
        # NO byte between the closing quote and the float payload
        self._sym("TMIX")
        self.w(f' "{base}"')
        self.vec_nl(weights)

    def write_options(self):
        hs = self.hset
        self.w("~o ")
        if hs.hmm_set_id:
            self._sym("HMMSETID")
            self.w(f" {hs.hmm_set_id} ")
        sw = hs.swidth
        self.kwn("STREAMINFO", len(sw), *sw)
        self.kwn("VECSIZE", hs.vec_size)
        self._sym(hs.dur_kind)
        self._sym("PARMKIND")
        self._short(hs.parm_kind)
        self._sym(hs.cov_kind)

    def end_macro(self):
        self.w("\n")


class _BinFile:
    """Tiny adapter: text fragments via write(str), raw via write_bytes."""

    def __init__(self, f):
        self.f = f

    def write(self, s: str):
        self.f.write(s.encode("latin-1"))

    def write_bytes(self, b: bytes):
        self.f.write(b)


def save_mmf(hset: HMMSet, path: str, binary: bool = False) -> None:
    """Write the complete HMMSet as one MMF (HModel.c : SaveHMMSet).

    binary=True (the tools' -B flag) writes HTK's ':'-code binary form:
    same macro structure, keywords as symbol bytes, parameters as raw
    big-endian shorts/floats.

    The MMF is the training checkpoint (SURVEY §5.4), so the write is
    ATOMIC: a temp file in the same directory is fsync'd and renamed
    over the target — a crash mid-save can never leave a truncated
    hmmdefs behind (the orbax-style guarantee SURVEY §5.3 calls for).
    """
    import os as _os
    import tempfile as _tempfile

    d = _os.path.dirname(_os.path.abspath(path)) or "."
    fd, tmp = _tempfile.mkstemp(dir=d, prefix=_os.path.basename(path) + ".",
                                suffix=".tmp")
    try:
        if binary:
            with _os.fdopen(fd, "wb") as f:
                _BinWriter(hset, _BinFile(f)).write_all()
                f.flush()
                _os.fsync(f.fileno())
        else:
            with _os.fdopen(fd, "w") as f:
                _Writer(hset, f).write_all()
                f.flush()
                _os.fsync(f.fileno())
        _os.replace(tmp, path)
    except BaseException:
        try:
            _os.unlink(tmp)
        except OSError:
            pass
        raise
