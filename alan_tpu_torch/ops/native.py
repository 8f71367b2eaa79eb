"""ctypes glue shared by the kernel wrappers: load a kernel library (built
at first use by ``_build``), pass tensor pointers and the current stream,
and turn a returned CUDA error code into an exception."""
from __future__ import annotations

import ctypes

import torch

#: ctypes argument types: a pointer (tensor or stream) and a C int
PTR, INT = ctypes.c_void_p, ctypes.c_int

_LIBS: dict = {}


def load(name: str, signatures: dict):
    """The library built from ``csrc/<name>.cu``, with each entry point of
    ``signatures`` (function name -> argument types) returning an int."""
    lib = _LIBS.get(name)
    if lib is None:
        from .._build import start_kernel
        lib = ctypes.CDLL(start_kernel(name).wait())
        for fn, argtypes in signatures.items():
            getattr(lib, fn).restype = INT
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return lib


def ptr(t):
    return PTR(t.data_ptr()) if t is not None else PTR(0)


def stream(t):
    return PTR(torch.cuda.current_stream(t.device).cuda_stream)


def check_status(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA error {rc}")
