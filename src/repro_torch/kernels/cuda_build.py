"""Build the port's CUDA sources with ``nvcc``, load them with ctypes, and
the checks every kernel wrapper makes before a launch.

Each ``csrc/*.cu`` file is compiled on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds)
for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -lineinfo -I csrc -I ../common/csrc \\
         -o build/lib<name>-<hash>.so csrc/<name>.cu

``-lineinfo`` adds line tables and nothing else (the code is the same),
so a report of compute-sanitizer or a profiler names the source line.

Headers shared by several kernels live in ``kernels/common/csrc/``, which
every build puts on the include path next to the source's own ``csrc/``.
The library name carries a hash of the flags, the source, the headers
beside it and the shared headers, so an edited kernel or header is rebuilt
and a stale library is never loaded.  Builds run on first
use (never at import), all missing sources in parallel, into a ``build/``
directory next to the sources that ``.gitignore`` lists.  ``nvcc`` is
looked up in ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``, then
``PATH``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Tuple

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

#: loaded libraries by absolute .so path (a process-wide cache: a shared
#: library is loaded once per process anyway)
_LOADED: Dict[str, ctypes.CDLL] = {}
#: build log lines (ptxas register/shared-memory reports) and seconds
#: spent compiling, for the smoke script's report
BUILD_REPORT: Dict[str, Tuple[float, str]] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                           "toolkit's bin/ on PATH")
    return found


def common_dir(src: Path) -> Path:
    """``kernels/common/csrc`` of the tree that holds
    ``kernels/<package>/csrc/<name>.cu``."""
    return src.parent.parent.parent / "common" / "csrc"


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    headers = sorted(src.parent.glob("*.cuh")) + \
        sorted(common_dir(src).glob("*.cuh"))
    for f in headers + [src]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return src.parent.parent / "build" / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def nvcc_args(src: Path, out: Path) -> List[str]:
    """The ``nvcc`` arguments (without the compiler) that build ``src``
    into the shared library ``out``."""
    return [*NVCC_FLAGS, "-I", str(src.parent), "-I", str(common_dir(src)),
            "-o", str(out), str(src)]


def build(sources: Iterable[Path]) -> Dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together; returns {stem: library path}.  Raises
    ``RuntimeError`` with the compiler's output if any build fails."""
    sources = list(sources)
    libs = {src.stem: _lib_path(src) for src in sources}
    jobs: List[Tuple[str, Path, Path, subprocess.Popen, float]] = []
    for src in sources:
        lib = libs[src.stem]
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *nvcc_args(src, tmp)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src.stem, lib, tmp, proc, time.perf_counter()))
    failed = []
    for stem, lib, tmp, proc, t0 in jobs:
        log, _ = proc.communicate()
        BUILD_REPORT[stem] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"{stem}:\n{log}")
            continue
        os.replace(tmp, lib)          # atomic: readers never see half a file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def load(src: Path) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = build([src])[src.stem]
    key = str(lib)
    if key not in _LOADED:
        _LOADED[key] = ctypes.CDLL(key)
    return _LOADED[key]


_FNS: Dict[Tuple[Path, str], Any] = {}


def c_function(src: Path, fn: str, nptrs: int, nints: int):
    """The C entry ``fn`` of ``src``'s library, typed: ``nptrs`` device
    pointers, ``nints`` ints, then the stream (all pointers and the
    stream as ``c_void_p``, so none is cut to 32 bits); returns int."""
    key = (src, fn)
    if key not in _FNS:
        f = getattr(load(src), fn)
        f.argtypes = [ctypes.c_void_p] * nptrs + [ctypes.c_int] * nints \
            + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _FNS[key] = f
    return _FNS[key]


def check_tensor(name: str, t, dev, dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-dim CUDA tensor of
    ``dtype`` on ``dev``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a tensor on a CUDA device, got "
                         f"{t.device}")
    if t.device != dev:
        raise ValueError(f"{name}: expected a tensor on {dev}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def raise_on(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
