"""HParse — EBNF grammar to word-network (SLF) compiler.

Mirrors `HTKTools/HParse.c`: the HTK grammar notation

  $var = expr ;          variable definition
  a b c                  sequence
  a | b                  alternatives
  [ expr ]               optional
  { expr }               zero or more repetitions
  < expr >               one or more repetitions
  ( expr )               grouping
  $var                   variable reference

compiles to an SLF word lattice (the input of HVite -w). Word nodes carry
the terminals; structure is built from !NULL nodes.

Usage: HParse [options] gramFile latFile
  Standard: -A -C -D -S -T -V

Copied from `htk_tpu/tools/hparse.py` into the PyTorch port: host code,
behaviour unchanged.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from ..io.slf import Lattice, LArc, LNode, NULL_WORD, write_slf
from ..utils.cli import parse_args, tool_main
from ..utils.errors import HError

USAGE = "Usage: HParse [options] gramFile latFile"


class _Parser:
    def __init__(self, text: str):
        text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
        text = re.sub(r"//[^\n]*", " ", text)
        self.toks = re.findall(r"[()\[\]{}<>|;=]|\$?[^\s()\[\]{}<>|;=]+", text)
        self.pos = 0
        self.vars = {}

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self):
        t = self.peek()
        if t is None:
            HError(3150, "HParse: unexpected end of grammar")
        self.pos += 1
        return t

    # grammar: { $var = expr ; } ( expr )
    def parse(self):
        while self.peek() is not None and self.peek().startswith("$"):
            name = self.next()
            if self.next() != "=":
                HError(3150, "HParse: expected = after %s", name)
            expr = self.parse_expr(stop={";"})
            if self.next() != ";":
                HError(3150, "HParse: expected ; after %s definition", name)
            self.vars[name] = expr
        main = self.parse_expr(stop=set())
        if self.peek() is not None:
            HError(3150, "HParse: trailing tokens at %s", self.peek())
        return main

    def parse_expr(self, stop):
        """alternatives of sequences -> ('alt', [('seq', [items])])"""
        alts = [self.parse_seq(stop | {"|"})]
        while self.peek() == "|":
            self.next()
            alts.append(self.parse_seq(stop | {"|"}))
        return ("alt", alts) if len(alts) > 1 else alts[0]

    def parse_seq(self, stop):
        items = []
        closers = {")", "]", "}", ">"}
        while True:
            t = self.peek()
            if t is None or t in stop or t in closers:
                break
            items.append(self.parse_item())
        if not items:
            HError(3150, "HParse: empty expression")
        return ("seq", items) if len(items) > 1 else items[0]

    def parse_item(self):
        t = self.next()
        if t == "(":
            e = self.parse_expr(stop=set())
            if self.next() != ")":
                HError(3150, "HParse: missing )")
            return e
        if t == "[":
            e = self.parse_expr(stop=set())
            if self.next() != "]":
                HError(3150, "HParse: missing ]")
            return ("opt", e)
        if t == "{":
            e = self.parse_expr(stop=set())
            if self.next() != "}":
                HError(3150, "HParse: missing }")
            return ("star", e)
        if t == "<":
            e = self.parse_expr(stop=set())
            if self.next() != ">":
                HError(3150, "HParse: missing >")
            return ("plus", e)
        if t.startswith("$"):
            if t not in self.vars:
                HError(3151, "HParse: undefined variable %s", t)
            return self.vars[t]
        if t in (")", "]", "}", ">", "|", ";", "="):
            HError(3150, "HParse: unexpected %s", t)
        return ("word", t)


class _LatBuilder:
    def __init__(self):
        self.nodes: List[LNode] = []
        self.arcs: List[LArc] = []

    def node(self, word=None) -> int:
        nid = len(self.nodes)
        self.nodes.append(LNode(id=nid, word=word if word else NULL_WORD))
        return nid

    def arc(self, s, e, p=0.0):
        self.arcs.append(LArc(id=len(self.arcs), start=s, end=e, lmlike=p))

    def build(self, ast) -> Tuple[int, int]:
        kind = ast[0]
        if kind == "word":
            n = self.node(ast[1])
            return n, n
        if kind == "seq":
            first_entry = None
            prev_exit = None
            for item in ast[1]:
                en, ex = self.build(item)
                if first_entry is None:
                    first_entry = en
                else:
                    self.arc(prev_exit, en)
                prev_exit = ex
            return first_entry, prev_exit
        if kind == "alt":
            s, e = self.node(), self.node()
            for item in ast[1]:
                en, ex = self.build(item)
                self.arc(s, en)
                self.arc(ex, e)
            return s, e
        if kind == "opt":
            s, e = self.node(), self.node()
            en, ex = self.build(ast[1])
            self.arc(s, en)
            self.arc(ex, e)
            self.arc(s, e)
            return s, e
        if kind == "star":
            s, e = self.node(), self.node()
            en, ex = self.build(ast[1])
            self.arc(s, en)
            self.arc(ex, e)
            self.arc(s, e)
            self.arc(ex, en)
            return s, e
        if kind == "plus":
            s, e = self.node(), self.node()
            en, ex = self.build(ast[1])
            self.arc(s, en)
            self.arc(ex, e)
            self.arc(ex, en)
            return s, e
        HError(3150, "HParse: bad AST node %s", kind)


def parse_grammar(text: str) -> Lattice:
    ast = _Parser(text).parse()
    b = _LatBuilder()
    start = b.node()
    en, ex = b.build(ast)
    end = b.node()
    b.arc(start, en)
    b.arc(ex, end)
    lat = Lattice(nodes=b.nodes, arcs=b.arcs)
    return lat


def run(argv: List[str]) -> int:
    ta = parse_args("HParse", argv, {}, min_args=2, usage=USAGE)
    gram_file, lat_file = ta.args[0], ta.args[1]
    try:
        text = open(gram_file).read()
    except OSError as e:
        HError(1011, "HParse: cannot open grammar %s (%s)", gram_file, e)
    lat = parse_grammar(text)
    write_slf(lat, lat_file)
    if ta.trace:
        print(f"HParse: {len(lat.nodes)} nodes, {len(lat.arcs)} arcs -> {lat_file}")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
