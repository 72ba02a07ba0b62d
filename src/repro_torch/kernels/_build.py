"""Build the port's CUDA sources with ``nvcc`` on first use; load with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
its own into ``<repo>/build/lib<name>-<hash>.so`` (the directory is listed
in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -I csrc -o build/lib<name>-<hash>.so \\
         csrc/<name>.cu

Sources may include the shared headers ``csrc/*.cuh``.  The hash covers
the source, every header and the flags, so an edited source or header
builds anew and a stale library is never loaded.  A build writes a temporary file and
renames it into place, so concurrent processes never load a half-written
library.  Nothing here runs at import time: the CPU tests import every
module on machines with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[str, Callable[..., int]] = {}
# the kernels index rows, entries and bags with int32
INT32_MAX = 2 ** 31 - 1
# name -> {"seconds": wall time of its nvcc, "log": nvcc's output (ptxas -v)}
BUILD_LOG: Dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels build "
                           "only where the CUDA toolkit is installed")
    return path


def build_dir() -> Path:
    """``<checkout>/build``.  The package must run from a checkout's
    ``src/``: an installed copy has no checkout to build into, so it raises
    instead of writing beside the interpreter's libraries."""
    root = _PKG.parents[1]
    if _PKG.parent.name != "src" or not (root / "pyproject.toml").is_file():
        raise RuntimeError(f"repro_torch at {_PKG} is not in a checkout's "
                           "src/; the CUDA kernels build only from a "
                           "checkout of the repository")
    return root / "build"


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(*names: str) -> Dict[str, Path]:
    """Compile every named source that is not built yet, all nvcc processes
    started together; returns name -> library path."""
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = out[n].with_name(f"{out[n].name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        BUILD_LOG[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if p.returncode:
            failed.append(f"{n}: nvcc exit {p.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[name]))
        _LIBS[name] = lib
    return lib


def entry(name: str, n_ptr: int, n_int: int, tail=()):
    """The C entry point ``name`` of ``csrc/<name>.cu``, built and loaded on
    first use: ``n_ptr`` pointers, ``n_int`` ints, then arguments of the
    ctypes types in ``tail``, then the stream; it returns a CUDA error
    code."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(load(name), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + list(tail) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn
