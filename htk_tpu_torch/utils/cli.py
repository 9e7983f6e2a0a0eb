"""HTK-style command-line machinery.

Mirrors `HTKLib/HShell.c` argument handling: every tool shares the standard
single-letter options (same letter = same meaning everywhere, enforced by
PrintStdOpts in HTK):

  -A        echo the command line
  -B        save output files in binary
  -C cf     read configuration file cf (repeatable)
  -D        display resolved configuration parameters
  -S f      read a script (.scp) file of data file names
  -T N      set trace level
  -V        print version information

plus per-tool letters declared by each tool (e.g. HERest's ``-H mmf -M dir
-t beams -u flags``). Parsing follows HTK's NextArg/GetStrArg/GetChkedInt
conventions: options are ``-x [value]``, everything else is positional.

Copied from `htk_tpu/utils/cli.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .config import Config
from .errors import HError, HTKError
from .. import __version__


@dataclass
class Option:
    letter: str
    nargs: int  # number of values following the flag (0 for boolean)
    help: str
    typ: Callable = str
    repeatable: bool = False
    # consume extra trailing values that parse as `typ` (HTK options with
    # optional arguments, e.g. HERest -t f [i l])
    greedy: bool = False


@dataclass
class ToolArgs:
    """Parsed command line for one tool invocation."""

    tool: str
    opts: Dict[str, list] = field(default_factory=dict)  # letter -> list of value-tuples
    args: List[str] = field(default_factory=list)  # positionals
    config: Config = field(default_factory=Config)
    trace: int = 0
    script: List[str] = field(default_factory=list)  # expanded -S entries
    binary: bool = False

    def has(self, letter: str) -> bool:
        return letter in self.opts

    def get(self, letter: str, default=None):
        """First value of a 1-arg option (or tuple for multi-arg)."""
        vs = self.opts.get(letter)
        if not vs:
            return default
        v = vs[-1]
        return v[0] if len(v) == 1 else v

    def get_all(self, letter: str) -> List:
        out = []
        for v in self.opts.get(letter, []):
            out.append(v[0] if len(v) == 1 else v)
        return out


STD_OPTS: Dict[str, Option] = {
    "A": Option("A", 0, "Print command line arguments"),
    "B": Option("B", 0, "Save output files in binary"),
    "C": Option("C", 1, "Set config file to cf", repeatable=True),
    "D": Option("D", 0, "Display configuration variables"),
    "S": Option("S", 1, "Set script file to f"),
    "T": Option("T", 1, "Set trace flags to N", typ=int),
    "V": Option("V", 0, "Print version information"),
}


def read_scp(path: str) -> List[str]:
    """Read a .scp script file: one data file per line (HShell script files).

    Supports HTK "extended filenames" transparently — entries are returned
    verbatim (``logical=physical`` aliasing and ``file[start,end]`` segment
    selection are interpreted by io.scp.parse_scp_entry at open time).
    """
    try:
        lines = open(path, "r").read().splitlines()
    except OSError as e:
        HError(1011, "ReadScript: cannot open script file %s (%s)", path, e)
    out = []
    for ln in lines:
        ln = ln.strip()
        if ln and not ln.startswith("#"):
            out.extend(ln.split())
    return out


def parse_args(
    tool: str,
    argv: List[str],
    tool_opts: Dict[str, Option],
    min_args: int = 0,
    usage: str = "",
) -> ToolArgs:
    """Parse argv (without program name) in HTK style."""
    all_opts = dict(STD_OPTS)
    all_opts.update(tool_opts)
    ta = ToolArgs(tool=tool)
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("-") and len(a) >= 2 and not _looks_numeric(a):
            letter = a[1:]
            opt = all_opts.get(letter)
            if opt is None:
                HError(1020, "%s: unknown option -%s\n%s", tool, letter, usage)
            vals: Tuple = ()
            if opt.nargs:
                if i + opt.nargs >= len(argv) + 1 and i + opt.nargs > len(argv) - 1 + 1:
                    pass
                if i + opt.nargs > len(argv) - 1:
                    HError(1021, "%s: option -%s expects %d value(s)", tool, letter, opt.nargs)
                raw = argv[i + 1 : i + 1 + opt.nargs]
                try:
                    vals = tuple(opt.typ(v) for v in raw)
                except ValueError:
                    HError(1022, "%s: bad value for -%s: %s", tool, letter, " ".join(raw))
                i += opt.nargs
                if opt.greedy:
                    while i + 1 < len(argv):
                        try:
                            vals = vals + (opt.typ(argv[i + 1]),)
                        except ValueError:
                            break
                        i += 1
            ta.opts.setdefault(letter, []).append(vals if vals else (True,))
        else:
            ta.args.append(a)
        i += 1

    ta.config = Config.load([v[0] for v in ta.opts.get("C", [])])
    # HShell semantics: the tool's TRACE config key sets the trace
    # level; -T on the command line overrides it
    if ta.has("T"):
        ta.trace = int(ta.get("T", 0) or 0)
    else:
        ta.trace = int(ta.config.int_("TRACE", 0, module=tool.upper()) or 0)
    ta.binary = ta.has("B")
    if ta.has("A"):
        print(" ".join([tool] + argv))
    if ta.has("V"):
        print(f"htk_tpu {tool} version {__version__}")
    if ta.has("D"):
        print(ta.config.dump())
    if ta.has("S"):
        ta.script = read_scp(ta.get("S"))
    if len(ta.args) < min_args:
        HError(1030, "%s: insufficient arguments\n%s", tool, usage)
    return ta


def _looks_numeric(a: str) -> bool:
    """'-5', '-0.5' are numeric positionals, not options (HTK behaviour)."""
    try:
        float(a)
        return True
    except ValueError:
        return False


def tool_main(fn: Callable[[List[str]], int]):
    """Wrap a tool entry point: HTKError -> numbered stderr exit code."""

    def main(argv: Optional[List[str]] = None) -> int:
        if argv is None:
            argv = sys.argv[1:]
        try:
            return fn(argv) or 0
        except HTKError as e:
            print(str(e), file=sys.stderr)
            return e.code // 100 % 256 or 1
        except BrokenPipeError:
            # stdout consumer (e.g. `| grep -q`) closed early — the Unix
            # convention is a silent success, not a traceback
            try:
                sys.stdout.close()
            except Exception:
                pass
            return 0

    return main
