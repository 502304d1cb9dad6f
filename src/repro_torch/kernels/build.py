"""Build the CUDA kernels from ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded through ``ctypes``. A source that includes
no PyTorch header builds in seconds. All sources build in parallel, one
``nvcc`` each, into ``build/repro_torch/`` at the repository root; the
library file name carries a hash of its source, of every ``csrc/*.cuh`` it
includes and of the flags, so an edited source or shared header never loads
a stale build. Importing this module runs nothing: only
:meth:`KernelLibraries.get` (reached from the first CUDA launch) builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("newton", "score", "gram", "swa")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
#: ctypes signatures of every C entry point, by library
SIGNATURES = {
    "newton": {
        "repro_newton_smem_bytes": ([_I, _I, _I, _I], _L),
        "repro_newton_partial_floats": ([_I, _I, _I, _I, _I, _I], _L),
        "repro_cuda_error_string": ([_I], ctypes.c_char_p),
        "repro_newton_stats": ([_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _P], _I),
    },
    "score": {
        "repro_score_max_channels": ([], _I),
        "repro_masked_workspace_words": ([_I, _I], _L),
        "repro_score_channels": ([_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _I, _I, _I, _I, _I, _P], _I),
        "repro_cl_logits": ([_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P],
                            _I),
    },
    "gram": {
        "repro_gram": ([_I, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    },
    "swa": {
        "repro_swa_supports": ([_I], _I),
        "repro_swa_attention": ([_I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                                 _P, _P], _I),
    },
}
_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+\.cuh)"', re.MULTILINE)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                       "the CUDA kernels are built from source at first use")


def _target(name: str) -> Path:
    text = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(text)
    for header in sorted(set(_LOCAL_INCLUDE.findall(text.decode()))):
        h.update(header.encode())
        h.update((CSRC / header).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


class KernelLibraries:
    """The loaded kernel libraries of this process.

    ``builds`` counts the ``nvcc`` runs this process made and ``build_s``
    their wall seconds (a parallel build is counted once per source, timed
    once); a session reads both around a call to report what it paid.
    ``ptxas`` keeps each build's register and shared-memory report.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._libs: Dict[str, ctypes.CDLL] = {}
        self.builds = 0
        self.build_s = 0.0
        self.ptxas: Dict[str, str] = {}

    def get(self, name: str) -> ctypes.CDLL:
        """The library built from ``csrc/<name>.cu`` (building every source
        that is not built yet on first use)."""
        with self._lock:
            if not self._libs:
                self._load_all()
            return self._libs[name]

    def build_all(self) -> float:
        """Build and load every source now; returns the seconds it took."""
        t0 = time.perf_counter()
        with self._lock:
            if not self._libs:
                self._load_all()
        return time.perf_counter() - t0

    def _load_all(self) -> None:
        todo = [s for s in SOURCES if not _target(s).exists()]
        if todo:
            self._build(todo)
        for name in SOURCES:
            lib = ctypes.CDLL(str(_target(name)))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            self._libs[name] = lib

    def _build(self, names: List[str]) -> None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for name in names:
            tmp = BUILD_DIR / f".{name}.{os.getpid()}.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            self.ptxas[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{out}")
                continue
            os.replace(tmp, _target(name))
        self.builds += len(names)
        self.build_s += time.perf_counter() - t0
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))


#: the process-wide libraries; nothing is built until a kernel launches
LIBRARIES = KernelLibraries()


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        text = LIBRARIES.get("newton").repro_cuda_error_string(err)
        raise RuntimeError(f"{what} failed: cudaError_t {err} "
                           f"({text.decode(errors='replace')})")
