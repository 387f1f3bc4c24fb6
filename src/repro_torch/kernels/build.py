"""Build and load the hand-written CUDA kernels.

Each ``.cu`` source under ``kernels/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded
with ``ctypes``. Builds happen at first use, on the machine with the
card, into ``<repo>/build/kernels``, one ``nvcc`` a source, all started
together by :func:`load_all`. The library's name carries a hash of its
source, of every file the source includes with ``#include "..."`` (the
shared ``sketch_tile.cuh``), and of the flags, so an edited source or
header is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC.parents[3] / "build" / "kernels"
SOURCES = {"sketch_wire": CSRC / "sketch_wire.cu",
           "sketch_codec": CSRC / "sketch_codec.cu",
           "adam_update": CSRC / "adam_update.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, dict] = {}   # name -> {"seconds", "path", "ptxas"}


def nvcc_path() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built with "
        "the CUDA toolkit on the machine with the card")


def _included(path: pathlib.Path) -> List[pathlib.Path]:
    """``path`` and every file it includes with ``#include "..."``,
    transitively, each once, in the order first reached."""
    seen: List[pathlib.Path] = []
    todo = [path.resolve()]
    while todo:
        p = todo.pop(0)
        if p in seen:
            continue
        seen.append(p)
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', p.read_text(),
                              flags=re.M):
            todo.append((p.parent / inc).resolve())
    return seen


def _library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for p in _included(SOURCES[name]):
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(names: Iterable[str]):
    """Build the missing libraries of ``names``: one ``nvcc`` a source,
    all started before any is waited for. Each compiles under a name of
    this process's own and is then renamed, so a process that loads the
    library never sees it half written."""
    started = []
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started.append((name, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, proc, t0 in started:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {SOURCES[name].name} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                           "path": str(out), "ptxas": log}
    if failed:
        raise RuntimeError("\n".join(failed))


def load_all(names: Iterable[str] = ()) -> Dict[str, ctypes.CDLL]:
    """The loaded libraries of ``names`` (default: every source), built
    in parallel where needed."""
    names = list(names) or list(SOURCES)
    with _LOCK:
        _compile(n for n in names if n not in _LIBS)
        for n in names:
            if n not in _LIBS:
                _LIBS[n] = ctypes.CDLL(str(_library_path(n)))
        return {n: _LIBS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built if needed."""
    return load_all([name])[name]
