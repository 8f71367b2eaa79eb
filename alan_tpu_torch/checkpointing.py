"""Checkpoint and resume of training state (counterpart of
``alan_tpu/checkpointing.py``).

A checkpoint is one tree, written as ``path.npz`` (the arrays) and
``path.json`` (the manifest): ``alan_tpu``'s layout and manifest types
(dict, tuple, list, DT with its dims, none, scalar, array), so that a P/Q
checkpoint written by either package loads in the other.  The port's own
leaves add to the manifest only fields that ``alan_tpu`` ignores:

* a dict with integer keys (``torch.optim.Adam``'s ``state_dict()``)
  lists them under ``int_keys``, since JSON turns keys into strings;
* an array records the device it came from (``device``);
* a ``torch.Generator`` is a ``generator`` leaf: its ``get_state()`` bytes
  as an array, and its device.  A generator registered with a CUDA graph
  (``train._Graph``) is replayed from the caller's generator, which is
  the one to save.

``load_checkpoint(path, device=None)`` puts every tensor back on the
device it was saved from, or on ``device`` where one is named.  A
generator comes back on the kind of device it was saved from, whatever
``device`` says: a CUDA generator's state (seed and offset) is no CPU
generator's.  Floats keep their bits, so a run resumed from a checkpoint
draws and steps as the uninterrupted one.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .dims import DT


def _array(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _encode(tree, prefix, arrays, manifest):
    if isinstance(tree, dict):
        manifest["type"] = "dict"
        manifest["children"] = {}
        int_keys = [str(k) for k in tree if isinstance(k, int)]
        if int_keys:
            manifest["int_keys"] = int_keys
        for k, v in tree.items():
            manifest["children"][str(k)] = child = {}
            _encode(v, f"{prefix}.{k}", arrays, child)
    elif isinstance(tree, (tuple, list)):
        manifest["type"] = "tuple" if isinstance(tree, tuple) else "list"
        manifest["children"] = []
        for i, v in enumerate(tree):
            child = {}
            _encode(v, f"{prefix}.{i}", arrays, child)
            manifest["children"].append(child)
    elif isinstance(tree, DT):
        manifest.update(type="DT", dims=list(tree.dims), key=prefix,
                        device=tree.data.device.type)
        arrays[prefix] = _array(tree.data)
    elif isinstance(tree, torch.Generator):
        manifest.update(type="generator", key=prefix, device=tree.device.type)
        arrays[prefix] = _array(tree.get_state())
    elif tree is None:
        manifest["type"] = "none"
    elif isinstance(tree, torch.Tensor):
        manifest.update(type="array", key=prefix, device=tree.device.type)
        arrays[prefix] = _array(tree)
    elif np.isscalar(tree) and not hasattr(tree, "shape"):
        manifest["type"] = "scalar"
        manifest["value"] = tree
    else:
        manifest["type"] = "array"
        manifest["key"] = prefix
        arrays[prefix] = np.asarray(tree)


def _decode(manifest, arrays, device):
    t = manifest["type"]
    if t == "dict":
        int_keys = set(manifest.get("int_keys", ()))
        return {(int(k) if k in int_keys else k): _decode(v, arrays, device)
                for k, v in manifest["children"].items()}
    if t in ("tuple", "list"):
        vals = [_decode(c, arrays, device) for c in manifest["children"]]
        return tuple(vals) if t == "tuple" else vals
    if t == "none":
        return None
    if t == "scalar":
        return manifest["value"]
    saved_on = manifest.get("device", "cpu")
    if t == "generator":
        on = torch.device(device if device is not None else saved_on)
        g = torch.Generator(device=on if on.type == saved_on else saved_on)
        g.set_state(torch.from_numpy(arrays[manifest["key"]]))
        return g
    data = torch.from_numpy(arrays[manifest["key"]]).to(
        torch.device(device if device is not None else saved_on))
    if t == "DT":
        return DT(data, tuple(manifest["dims"]))
    return data


def save_checkpoint(path: str, state) -> None:
    """Write a tree of dicts, tuples, lists, DTs, tensors, generators, None
    and Python scalars to ``path.npz`` and ``path.json``."""
    arrays, manifest = {}, {}
    _encode(state, "root", arrays, manifest)
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)


def load_checkpoint(path: str, device=None):
    """The tree that ``save_checkpoint`` wrote (or ``alan_tpu``'s), its
    tensors on ``device`` (default: where each was saved from)."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    with np.load(path + ".npz") as npz:
        arrays = dict(npz)
    return _decode(manifest, arrays, device)


def save_problem(path: str, problem, extra=None) -> None:
    """Checkpoint a Problem's P and Q states, with ``extra`` (the
    optimizer's state, a generator, ...)."""
    save_checkpoint(path, {"P": problem.P.state(), "Q": problem.Q.state(),
                           "extra": extra})


def load_problem(path: str, problem, device=None):
    """Restore a Problem's P and Q states in place, on its device unless
    ``device`` is named; returns the extras."""
    ck = load_checkpoint(path, problem.device if device is None else device)
    problem.P.set_state(ck["P"])
    problem.Q.set_state(ck["Q"])
    return ck.get("extra")
