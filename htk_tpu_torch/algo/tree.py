"""Decision-tree state clustering (HHEd TB/AU).

Mirrors `HTKTools/HHEd.c` tree clustering: states of a triphone family
pool into a phonetic decision tree; each node asks the QS question that
maximises the pooled single-Gaussian log-likelihood gain; leaves become
tied states. Runs on host from device-computed occupancy stats (SURVEY.md
§3.4) — the stats are tiny, the search is cheap, and determinism of
tie-breaking matters more than speed here (questions are tried in
definition order; ties keep the earlier question, matching HTK).

The log-likelihood of a state cluster S under a shared diagonal Gaussian:

  L(S) = -0.5 * occ(S) * sum_d (log(2*pi) + 1 + log var_d(S))

with var_d(S) the occupancy-weighted pooled variance. Split gain =
L(yes) + L(no) - L(parent).

Copied from `htk_tpu/algo/tree.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot import htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

import fnmatch
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.mmf import HMMSet, StateInfo
from ..utils.errors import HError, HRError


@dataclass
class Question:
    name: str
    patterns: List[str]  # context patterns, e.g. ["aa-*", "ao-*"]

    def matches(self, context: str) -> bool:
        return any(fnmatch.fnmatchcase(context, p) for p in self.patterns)


@dataclass
class TreeNode:
    question: Optional[str] = None  # None = leaf
    yes: Optional["TreeNode"] = None
    no: Optional["TreeNode"] = None
    macro: Optional[str] = None  # leaf tied-state macro name


@dataclass
class Tree:
    base_phone: str
    state_idx: int
    root: TreeNode = field(default_factory=TreeNode)


def parse_triphone(name: str) -> Tuple[Optional[str], str, Optional[str]]:
    """'l-b+r' -> (l, b, r); monophone -> (None, b, None)."""
    left = None
    right = None
    rest = name
    if "-" in rest:
        left, rest = rest.split("-", 1)
    if "+" in rest:
        rest, right = rest.split("+", 1)
    return left, rest, right


@dataclass
class _StateStats:
    """Pooled sufficient stats for one (possibly shared) state."""

    occ: float
    mean: np.ndarray  # occupancy-weighted mean
    sqr: np.ndarray  # occupancy-weighted E[x^2] = var + mean^2


def state_stats(si: StateInfo, occ: float) -> _StateStats:
    """Single-Gaussian sufficient stats for a state (1-mix required)."""
    se = si.streams[0]
    mp = se.mixes[0]
    mean = mp.mean.astype(np.float64)
    var = mp.var.astype(np.float64)
    return _StateStats(occ=occ, mean=mean, sqr=var + mean * mean)


def _cluster_ll(members: Sequence[_StateStats]) -> float:
    occ = sum(m.occ for m in members)
    if occ <= 0:
        return 0.0
    d = len(members[0].mean)
    mean = sum(m.occ * m.mean for m in members) / occ
    sqr = sum(m.occ * m.sqr for m in members) / occ
    var = np.maximum(sqr - mean * mean, 1e-6)
    return -0.5 * occ * float(d * (math.log(2 * math.pi) + 1.0) + np.sum(np.log(var)))


def _cluster_occ(members: Sequence[_StateStats]) -> float:
    return sum(m.occ for m in members)


def build_tree(
    base_phone: str,
    state_idx: int,
    entries: List[Tuple[str, _StateStats]],  # (triphone name, stats)
    questions: Sequence[Question],
    threshold: float,
    min_occ: float = 0.0,
) -> Tuple[Tree, Dict[int, List[str]]]:
    """Greedy top-down clustering; returns tree + leaf -> member names."""
    tree = Tree(base_phone=base_phone, state_idx=state_idx)

    # precompute question answers per entry: context string "l-b+r"
    ans: Dict[str, List[bool]] = {}
    for name, _ in entries:
        ans[name] = [q.matches(name) for q in questions]

    leaves: List[Tuple[TreeNode, List[Tuple[str, _StateStats]]]] = [
        (tree.root, list(entries))
    ]
    done: List[Tuple[TreeNode, List[Tuple[str, _StateStats]]]] = []

    while leaves:
        node, members = leaves.pop(0)
        if len(members) <= 1:
            done.append((node, members))
            continue
        stats = [s for _, s in members]
        parent_ll = _cluster_ll(stats)
        best_gain = threshold
        best_q = -1
        best_split = None
        for qi, q in enumerate(questions):
            yes = [(n, s) for n, s in members if ans[n][qi]]
            no = [(n, s) for n, s in members if not ans[n][qi]]
            if not yes or not no:
                continue
            if min_occ > 0 and (
                _cluster_occ([s for _, s in yes]) < min_occ
                or _cluster_occ([s for _, s in no]) < min_occ
            ):
                continue
            gain = (
                _cluster_ll([s for _, s in yes])
                + _cluster_ll([s for _, s in no])
                - parent_ll
            )
            if gain > best_gain:  # strict >: ties keep earlier question
                best_gain = gain
                best_q = qi
                best_split = (yes, no)
        if best_q < 0:
            done.append((node, members))
            continue
        node.question = questions[best_q].name
        node.yes = TreeNode()
        node.no = TreeNode()
        leaves.append((node.yes, best_split[0]))
        leaves.append((node.no, best_split[1]))

    leaf_members: Dict[int, List[str]] = {}
    for k, (node, members) in enumerate(done):
        node.macro = f"__leaf_{k}"  # renamed by caller
        leaf_members[k] = [n for n, _ in members]
    # stash nodes in order for caller renaming
    tree._leaves = [node for node, _ in done]  # type: ignore[attr-defined]
    return tree, leaf_members


def classify(tree: Tree, questions: Dict[str, Question], name: str) -> str:
    """Descend the tree for a (possibly unseen) triphone; returns macro."""
    node = tree.root
    while node.question is not None:
        q = questions.get(node.question)
        if q is None:
            HError(2662, "classify: unknown question %s", node.question)
        node = node.yes if q.matches(name) else node.no
    return node.macro


# -- tree file I/O (HHEd ST/LT format) --------------------------------------


def save_trees(path: str, questions: Sequence[Question], trees: Sequence[Tree]):
    """Write questions + trees in HHEd ST format."""
    with open(path, "w") as f:
        for q in questions:
            pats = ",".join(f'"{p}"' for p in q.patterns)
            f.write(f"QS '{q.name}' {{ {pats} }}\n")
        for t in trees:
            f.write(f"\n{t.base_phone}[{t.state_idx}]\n")
            if t.root.question is None:
                f.write(f'   "{t.root.macro}"\n')
                continue
            f.write("{\n")
            # number internal nodes 0, -1, -2, ... breadth-first (HTK style)
            nodes: List[TreeNode] = []

            def collect(n):
                if n.question is not None:
                    nodes.append(n)
                    collect(n.no)
                    collect(n.yes)

            collect(t.root)
            num = {id(n): -i for i, n in enumerate(nodes)}

            def ref(n):
                if n.question is None:
                    return f'"{n.macro}"'
                return str(num[id(n)])

            for n in nodes:
                f.write(f"   {num[id(n)]:3d} '{n.question}' {ref(n.no)} {ref(n.yes)}\n")
            f.write("}\n")


def load_trees(path: str):
    """Read an ST/LT tree file; returns (questions dict, trees list)."""
    import re

    text = open(path).read()
    questions: Dict[str, Question] = {}
    trees: List[Tree] = []
    qs_re = re.compile(r"QS\s+'(?P<name>[^']+)'\s*\{(?P<pats>[^}]*)\}")
    pos = 0
    for m in qs_re.finditer(text):
        pats = [p.strip().strip('"') for p in m.group("pats").split(",") if p.strip()]
        questions[m.group("name")] = Question(name=m.group("name"), patterns=pats)
        pos = m.end()
    # tree sections
    hdr_re = re.compile(r"^\s*(?P<ph>[^\s{}']+)\[(?P<st>\d+)\]\s*$", re.M)
    for hm in hdr_re.finditer(text, pos):
        ph, st = hm.group("ph"), int(hm.group("st"))
        rest = text[hm.end():].lstrip()
        tree = Tree(base_phone=ph, state_idx=st)
        if rest.startswith('"'):
            mac = rest[1 : rest.index('"', 1)]
            tree.root.macro = mac
            trees.append(tree)
            continue
        if not rest.startswith("{"):
            HRError(2661, "load_trees: malformed tree for %s[%d]", ph, st)
            continue
        body = rest[1 : rest.index("}")]
        nodes: Dict[int, TreeNode] = {}
        rows = []
        row_re = re.compile(
            r"(?P<id>-?\d+)\s+'(?P<q>[^']+)'\s+(?P<no>\"[^\"]+\"|-?\d+)\s+"
            r"(?P<yes>\"[^\"]+\"|-?\d+)"
        )
        for rm in row_re.finditer(body):
            rows.append(rm)
            nodes[int(rm.group("id"))] = TreeNode()
        for rm in rows:
            n = nodes[int(rm.group("id"))]
            n.question = rm.group("q")

            def link(tok):
                if tok.startswith('"'):
                    leaf = TreeNode()
                    leaf.macro = tok.strip('"')
                    return leaf
                return nodes[int(tok)]

            n.no = link(rm.group("no"))
            n.yes = link(rm.group("yes"))
        tree.root = nodes[0]
        trees.append(tree)
    return questions, trees
