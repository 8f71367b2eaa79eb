"""ctypes binding for the native contraction-path planner, the same
``csrc/pathopt.cpp`` that ``alan_tpu/ops/pathopt.py`` binds.

The contraction order decides whether the lazy low-rank factor meets its
co-factors in a single step, and so whether the fused kernel runs at all;
both packages therefore plan with this one planner.  It is built with g++
at first use (``alan_tpu_torch/_build.py``); a failed build raises, there is
no fallback to another planner.  Plans are cached per program structure.
"""
from __future__ import annotations

import ctypes
import functools

_LIB = None


def _load():
    global _LIB
    if _LIB is None:
        from .._build import start_planner
        lib = ctypes.CDLL(start_planner().wait())
        lib.alan_plan_path.restype = ctypes.c_int
        lib.alan_plan_path.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=4096)
def plan_path(factor_dims: tuple[tuple[str, ...], ...],
              dim_sizes: tuple[tuple[str, int], ...],
              out_dims: tuple[str, ...],
              max_optimal: int = 12):
    """An opt_einsum-style linear path (tuple of index tuples).  All
    arguments are hashable, so each program structure is planned once."""
    sizes = dict(dim_sizes)
    names = list(sizes.keys())
    if len(names) >= 64 or len(factor_dims) >= 64:
        raise ValueError("the native planner takes fewer than 64 dims and factors")
    lib = _load()
    idx = {d: i for i, d in enumerate(names)}
    offsets = [0]
    flat = []
    for dims in factor_dims:
        flat.extend(idx[d] for d in dims)
        offsets.append(len(flat))
    n = len(factor_dims)
    c_off = (ctypes.c_int * len(offsets))(*offsets)
    c_flat = (ctypes.c_int * max(len(flat), 1))(*flat)
    c_sizes = (ctypes.c_double * len(names))(*[float(sizes[d]) for d in names])
    c_out = (ctypes.c_int * max(len(out_dims), 1))(*[idx[d] for d in out_dims])
    c_path = (ctypes.c_int * (2 * max(n - 1, 1)))()
    m = lib.alan_plan_path(n, c_off, c_flat, len(names), c_sizes, c_out,
                           len(out_dims), max_optimal, c_path)
    if m <= 0:
        raise RuntimeError(f"native planner found no path for {factor_dims}")
    out = []
    for i in range(m):
        a, b = c_path[2 * i], c_path[2 * i + 1]
        out.append((a,) if b < 0 else (a, b))
    return tuple(out)
