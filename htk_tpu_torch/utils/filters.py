"""HShell-style I/O filters (HShell.c xxFILTER configs).

HTK lets any input channel run through a shell command before the
reader sees it: ``HPARMFILTER = gunzip -c $`` decompresses feature
files on the fly, ``HWAVEFILTER``/``HDICTFILTER``/``HNETFILTER``/
``HLABELFILTER``/``HLANGMODFILTER``/``HMMLISTFILTER``/``HMMDEFFILTER``
cover the other channels. ``$`` in the command is replaced by the
(shell-quoted) file name; a command with no ``$`` receives the file on
stdin. The filtered bytes land in a temporary file whose path is handed
to the unchanged reader, so format sniffing and binary seeks keep
working. Output filters (xxOFILTER) are the symmetric write-side hook.

Readers stay filter-agnostic: call ``maybe_filter(path, KEY, cfg)``
around the open and ``cleanup(...)`` after (or use ``filtered()``).

Copied from `htk_tpu/utils/filters.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

import contextlib
import os
import shlex
import subprocess
import tempfile
from typing import Optional, Tuple

from .errors import HError

# channel key -> HTK config name, for reference/documentation
INPUT_FILTERS = (
    "HWAVEFILTER", "HPARMFILTER", "HLABELFILTER", "HDICTFILTER",
    "HNETFILTER", "HLANGMODFILTER", "HMMLISTFILTER", "HMMDEFFILTER",
)


def maybe_filter(path: str, key: str, cfg) -> Tuple[str, Optional[str]]:
    """Apply the ``key`` input filter to ``path`` if configured.

    Returns (path_to_read, temp_path_or_None). The caller removes the
    temp file when done (``cleanup``)."""
    spec = cfg.str_(key, None) if cfg is not None else None
    if not spec:
        return path, None
    if "$" in spec:
        cmd = spec.replace("$", shlex.quote(path))
        stdin = None
    else:
        cmd = spec
        stdin = open(path, "rb")
    fd, tmp = tempfile.mkstemp(prefix="htkflt_")
    try:
        with os.fdopen(fd, "wb") as out:
            r = subprocess.run(cmd, shell=True, stdin=stdin, stdout=out,
                               stderr=subprocess.PIPE)
        if r.returncode != 0:
            os.unlink(tmp)
            HError(1013, "%s filter '%s' failed on %s: %s", key, spec,
                   path, r.stderr.decode(errors="replace").strip())
    finally:
        if stdin is not None:
            stdin.close()
    return tmp, tmp


def cleanup(tmp: Optional[str]) -> None:
    if tmp is not None:
        with contextlib.suppress(OSError):
            os.unlink(tmp)


@contextlib.contextmanager
def filtered(path: str, key: str, cfg):
    """Context manager form: yields the path to read."""
    p, tmp = maybe_filter(path, key, cfg)
    try:
        yield p
    finally:
        cleanup(tmp)


@contextlib.contextmanager
def filtered_output(path: str, key: str, cfg):
    """Write-side xxOFILTER hook (e.g. ``HPARMOFILTER = gzip -c > $``).

    Yields the path the writer should produce. With no filter that is
    ``path`` itself. With a filter, the writer lands in a temp file
    whose bytes are piped to the command on stdin; ``$`` is replaced by
    the (quoted) destination, and a command with no ``$`` writes the
    destination from its stdout."""
    spec = cfg.str_(key, None) if cfg is not None else None
    if not spec:
        yield path
        return
    fd, tmp = tempfile.mkstemp(prefix="htkoflt_")
    os.close(fd)
    try:
        yield tmp
        with open(tmp, "rb") as produced:
            if "$" in spec:
                cmd = spec.replace("$", shlex.quote(path))
                r = subprocess.run(cmd, shell=True, stdin=produced,
                                   stderr=subprocess.PIPE)
            else:
                with open(path, "wb") as out:
                    r = subprocess.run(spec, shell=True, stdin=produced,
                                       stdout=out, stderr=subprocess.PIPE)
        if r.returncode != 0:
            HError(1013, "%s output filter '%s' failed for %s: %s", key,
                   spec, path, r.stderr.decode(errors="replace").strip())
    finally:
        cleanup(tmp)
