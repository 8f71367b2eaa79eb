"""Build the port's native libraries at first use.

Two shared libraries with plain C interfaces, loaded with ctypes:

* ``libalanpath`` -- the contraction-path planner, ``csrc/pathopt.cpp`` at the
  repository root (the same source ``alan_tpu`` builds), compiled with g++;
* ``liblowrank_lse`` -- the lazy low-rank contraction kernels,
  ``alan_tpu_torch/csrc/lowrank_lse.cu``, compiled with nvcc for ``sm_90a``.

Each goes into ``alan_tpu_torch/_native/`` under a name that carries a hash
of its source and flags, so an edited source is rebuilt and never mixed up
with an old build.  A build writes a temporary file and renames it into
place, so processes that build at the same time do not see half a library.
:func:`start_all` starts every compiler at once, for callers that want the
builds to overlap.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(_PKG, "_native")
PLANNER_SRC = os.path.join(os.path.dirname(_PKG), "csrc", "pathopt.cpp")
KERNEL_SRC = os.path.join(_PKG, "csrc", "lowrank_lse.cu")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the lazy low-rank CUDA kernels build only where the "
        "CUDA toolkit is installed")


class _Build:
    """One compiler run producing ``path``; ``wait()`` returns the path or
    raises with the compiler's output."""

    def __init__(self, name: str, compiler: list[str], src: str,
                 flags: list[str]):
        with open(src, "rb") as fh:
            digest = hashlib.sha256(fh.read() + " ".join(flags).encode())
        self.path = os.path.join(NATIVE_DIR,
                                 f"lib{name}-{digest.hexdigest()[:12]}.so")
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


def start_kernels() -> _Build:
    return _Build("lowrank_lse", [_nvcc()], KERNEL_SRC, NVCC_FLAGS)


def start_all() -> list[_Build]:
    """Start the planner and kernel builds together; ``wait()`` on each."""
    return [start_planner(), start_kernels()]
