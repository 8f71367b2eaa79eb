"""Build the port's native libraries at first use.

Shared libraries with plain C interfaces, loaded with ctypes:

* ``libalanpath`` -- the contraction-path planner, ``csrc/pathopt.cpp`` at the
  repository root (the same source ``alan_tpu`` builds), compiled with g++;
* one library per CUDA source in ``alan_tpu_torch/csrc/`` (:data:`KERNELS`),
  compiled with nvcc for ``sm_90a``: the lazy low-rank contraction
  (``lowrank_lse``), the small-K chain log-matmul (``smallk_logmmexp``) and
  the fused log-matmul (``logmmexp``).

Also one program, ``alan-grid`` (:func:`start_grid_runner`), the
experiment-grid executor, from the repository's ``csrc/gridrunner.cpp``
with ``csrc/Makefile``'s flags.

Each goes into ``alan_tpu_torch/_native/`` under a name that carries a hash
of its source, the headers beside the CUDA sources (:data:`HEADERS`) and the
flags, so an edited source or header is rebuilt and never mixed up with an
old build.  A build writes a temporary file and renames it into
place, so processes that build at the same time do not see half a library.
:func:`start_all` starts every compiler at once, for callers that want the
builds to overlap.
"""
from __future__ import annotations

import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(_PKG, "_native")
PLANNER_SRC = os.path.join(os.path.dirname(_PKG), "csrc", "pathopt.cpp")
GRID_SRC = os.path.join(os.path.dirname(_PKG), "csrc", "gridrunner.cpp")
#: CUDA kernels: library name -> source
KERNELS = {name: os.path.join(_PKG, "csrc", f"{name}.cu")
           for name in ("lowrank_lse", "smallk_logmmexp", "logmmexp")}
#: headers beside the CUDA sources, part of every kernel library's hash
HEADERS = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cuh")))

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]
GRID_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels build only where the CUDA "
        "toolkit is installed")


class _Build:
    """One compiler run producing ``path``; ``wait()`` returns the path or
    raises with the compiler's output."""

    def __init__(self, name: str, compiler: list[str], src: str,
                 flags: list[str], deps: list[str] = (), filename: str = "lib{}-{}.so"):
        digest = hashlib.sha256()
        for path in (src, *deps):
            with open(path, "rb") as fh:
                digest.update(fh.read())
        digest.update(" ".join(flags).encode())
        self.path = os.path.join(NATIVE_DIR,
                                 filename.format(name, digest.hexdigest()[:12]))
        self.log = ""
        self._proc = None
        if os.path.exists(self.path):
            return
        os.makedirs(NATIVE_DIR, exist_ok=True)
        self._tmp = f"{self.path}.{os.getpid()}.tmp"
        self._proc = subprocess.Popen(
            [*compiler, *flags, "-o", self._tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def wait(self) -> str:
        if self._proc is not None:
            self.log, _ = self._proc.communicate()
            rc = self._proc.returncode
            self._proc = None
            if rc != 0:
                if os.path.exists(self._tmp):
                    os.remove(self._tmp)
                raise RuntimeError(f"build of {self.path} failed (exit {rc}):\n"
                                   f"{self.log}")
            os.replace(self._tmp, self.path)
        return self.path


def start_planner() -> _Build:
    return _Build("alanpath", ["g++"], PLANNER_SRC, GXX_FLAGS)


def start_grid_runner() -> _Build:
    """Start (or find) the g++ build of the ``alan-grid`` executable."""
    return _Build("alan-grid", ["g++"], GRID_SRC, GRID_FLAGS, filename="{}-{}")


def start_kernel(name: str) -> _Build:
    """Start (or find) the nvcc build of the CUDA source ``KERNELS[name]``."""
    return _Build(name, [_nvcc()], KERNELS[name], NVCC_FLAGS, HEADERS)


def start_all() -> list[_Build]:
    """Start the planner and every kernel build together; ``wait()`` on each."""
    return [start_planner(), *(start_kernel(name) for name in KERNELS)]
