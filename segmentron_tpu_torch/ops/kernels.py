"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so`` inside the
package (``.gitignore`` lists it) the first time it is needed, then
loaded with ``ctypes``. The hash is of the source and of the headers it
includes from ``csrc/`` (``#include "<name>.cuh"``), so an edited source or
header is rebuilt. Nothing is built or loaded at import time. ``DEFINES`` maps a
source to extra compiler flags (a probe build); they enter the hash.
``build_variants`` builds one source with several sets of flags at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

__all__ = ["DEFINES", "SOURCES", "build", "build_variants", "library"]

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("entrychain", "sepconv", "attention", "attention_bwd", "probe_dot")
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
DEFINES: Dict[str, Tuple[str, ...]] = {}
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _headers(source: bytes) -> bytes:
    """The bytes of the ``csrc/`` headers that ``source`` includes with
    quotes, in the order it names them."""
    names = re.findall(rb'^\s*#\s*include\s+"([^"]+)"', source, flags=re.M)
    return b"".join((_SRC / n.decode()).read_bytes() for n in names)


def _target(name: str, flags: Sequence[str] | None = None) -> Path:
    """The library of ``csrc/<name>.cu`` built with ``flags`` (None: its
    ``DEFINES``)."""
    flags = " ".join(DEFINES.get(name, ()) if flags is None else flags).encode()
    source = (_SRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + _headers(source) + flags).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every source in ``names`` that has no library yet, one
    ``nvcc`` each, all started together. Returns seconds per source
    (0.0 for one already built); raises with the compiler's output when
    a build fails. The compiler's report (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside each library as ``.log``."""
    return _build({name: (name, tuple(DEFINES.get(name, ()))) for name in names})


def build_variants(name: str, variants: Dict[str, Tuple[str, ...]]) -> Dict[str, Path]:
    """The libraries of ``csrc/<name>.cu`` built with each set of flags in
    ``variants`` (probe builds), compiled as ``build`` compiles, all at
    once: {variant: library path}, each with its ``.log`` beside it."""
    _build({v: (name, flags) for v, flags in variants.items()})
    return {v: _target(name, flags) for v, flags in variants.items()}


def _build(jobs: Dict[str, Tuple[str, Tuple[str, ...]]]) -> Dict[str, float]:
    """Compile each job (source, flags) that has no library yet, all
    started together; seconds per job."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    times = {}
    for key, (name, flags) in jobs.items():
        out = _target(name, flags)
        if out.exists():
            times[key] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, *flags, "-o", str(tmp), str(_SRC / f"{name}.cu")]
        procs[key] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out, time.perf_counter())
    failed = []
    for key, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        times[key] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            name, flags = jobs[key]
            failed.append(f"nvcc failed for {' '.join((f'{name}.cu', *flags))}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return times


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
