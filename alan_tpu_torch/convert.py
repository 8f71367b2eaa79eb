"""Carry ``alan_tpu`` state, particle trees and data across as numpy.

Imports nothing of JAX: the input is numpy.  A leaf of an input tree is a
numpy array (no dims), ``None``, or an object with ``.data`` (numpy) and
``.dims`` attributes, such as ``alan_tpu``'s ``DT`` after
``jax.tree.map(np.asarray, tree)``.

* :func:`state_from_numpy` takes the tree that ``BoundPlate.state()``
  returns (``{"opt": ..., "qem_params": ..., "qem_means": ...}``);
* :func:`tree_from_numpy` takes a particle tree or a data dict;
* :func:`dt_from_numpy` takes one array and its dim names.

Floating arrays become float32 tensors, integer arrays int64, on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from .dims import DT


def dt_from_numpy(array, dims=(), device="cuda") -> DT:
    a = np.asarray(array)
    if a.dtype.kind == "f":
        t = torch.from_numpy(np.array(a, dtype=np.float32))
    elif a.dtype.kind in "iu":
        t = torch.from_numpy(np.array(a, dtype=np.int64))
    elif a.dtype.kind == "b":
        t = torch.from_numpy(np.array(a))
    else:
        raise TypeError(f"unsupported dtype {a.dtype}")
    return DT(t.to(torch.device(device)), tuple(dims))


def _leaf(x, device):
    if x is None:
        return None
    if hasattr(x, "dims") and hasattr(x, "data"):
        return dt_from_numpy(x.data, x.dims, device)
    return dt_from_numpy(x, (), device)


def tree_from_numpy(tree, device="cuda"):
    """Nested dicts of numpy leaves -> the same nesting of port ``DT``s."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def state_from_numpy(tree, device="cuda") -> dict:
    """``BoundPlate.state()`` of ``alan_tpu`` (as numpy) -> the port's state."""
    missing = {"opt", "qem_params", "qem_means"} - set(tree)
    if missing:
        raise KeyError(f"not a BoundPlate state: missing {sorted(missing)}")
    return {k: tree_from_numpy(tree[k], device)
            for k in ("opt", "qem_params", "qem_means")}
