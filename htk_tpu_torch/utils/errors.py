"""HTK-style numbered error reporting.

Mirrors `HTKLib/HShell.c : HError()/HRError()`: every fatal error carries a
numbered code in a per-module block (e.g. 6xxx = HParm, 7xxx = HModel).
Recipes occasionally grep stderr for these codes, so we keep the
`  ERROR [+NNNN]  message` output shape.

Module code blocks (canonical HTK assignments):
  10xx HShell  20xx HMem    52xx HMath   54xx HSigP   58xx HVQ
  6xxx HParm   62xx HWave   61xx HAudio  65xx HLabel  70xx-73xx HModel
  72xx HUtil   71xx HTrain  73xx HFB     75xx HDict   81xx HLM
  82xx HLat    85xx HRec    86xx HNet    1xxxx tools

Copied from `htk_tpu/utils/errors.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

import contextlib
import struct
import sys


class HTKError(Exception):
    """Fatal HTK error with numeric code (HError equivalent)."""

    def __init__(self, code: int, message: str):
        self.code = code
        self.message = message
        super().__init__(f"ERROR [+{code}]  {message}")


def HError(code: int, fmt: str, *args) -> "NoReturn":  # noqa: F821
    """Raise a fatal numbered error (HShell.c : HError)."""
    msg = (fmt % args) if args else fmt
    raise HTKError(code, msg)


def HRError(code: int, fmt: str, *args) -> None:
    """Report a recoverable numbered warning (HShell.c : HRError)."""
    msg = (fmt % args) if args else fmt
    print(f"  WARNING [-{code}]  {msg}", file=sys.stderr)


@contextlib.contextmanager
def contained(code: int, what: str, path: str):
    """Convert parse crashes on damaged input into the module's
    numbered error.

    HTK readers die with `ERROR [+NNNN]` on any malformed file; wrapping
    a reader's parse body in `with contained(6350, "read_htk_file", p):`
    gives truncated/corrupt inputs the same contract instead of leaking
    ValueError/struct.error/UnicodeDecodeError tracebacks to the CLI
    (exercised by tests/test_fuzz_readers.py). HTKError passes through
    untouched so specific numbered errors keep their codes."""
    try:
        yield
    except HTKError:
        raise
    except (ValueError, KeyError, IndexError, AttributeError, TypeError,
            OverflowError, EOFError, UnicodeDecodeError,
            struct.error) as e:
        HError(code, "%s: corrupt or truncated file %s (%s: %s)",
               what, path, type(e).__name__, e)
