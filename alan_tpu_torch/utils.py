"""Shared helpers: device resolution, function introspection, reserved
names, tree utilities and the per-traversal random-number dispenser
(counterpart of ``alan_tpu/utils.py``)."""
from __future__ import annotations

import inspect

import torch

from .dims import DT

Number = (int, float)


def resolve_device(device) -> torch.device:
    """The port's device rule: ``"cuda"`` (the default of every entry point)
    needs a card and raises without one; only an explicit ``"cpu"`` runs on
    the host.  On CUDA the f32 matmul precision is pinned to full f32: TF32
    stays off for ``torch.matmul`` and convolutions, because one TF32
    product keeps ~3 digits and the factored log-densities reach ~1e4-1e6
    and cancel.  The lazy low-rank kernels (``ops/lowrank_kernel.py``) do
    use the TF32 tensor cores, but as a 3xTF32 split (hi/lo parts of both
    operands, three products per multiply-add, ~2^-22 of each term), which
    keeps f32 grade."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but no CUDA card is present; pass "
                "device='cpu' to run on the host")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def assert_full_f32(device: torch.device):
    """Fail if TF32 was switched back on for CUDA matmuls or convolutions."""
    if device.type == "cuda" and (torch.backends.cuda.matmul.allow_tf32
                                  or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("TF32 is enabled; the port needs full f32 products")


def function_arguments(f):
    """Argument names of a user lambda; enforce a plain signature."""
    argspec = inspect.getfullargspec(f)
    if argspec.varargs is not None:
        raise Exception("functions used in a model may not have *args")
    if argspec.varkw is not None:
        raise Exception("functions used in a model may not have **kwargs")
    if (argspec.defaults is not None) or (argspec.kwonlydefaults is not None):
        raise Exception("functions used in a model may not have default args")
    if argspec.kwonlyargs:
        raise Exception("functions used in a model may not have keyword-only args")
    if argspec.annotations:
        raise Exception("functions used in a model may not have type annotations")
    return argspec.args


reserved_names = [
    "prev", "plate", "prog", "sample", "groupvarname2Kdim",
    "inputs", "params", "inputs_params_named", "N",
]
reserved_prefixes = ["K_"]


def check_name(name: str):
    if name in reserved_names:
        raise Exception(f"{name} is a reserved name")
    for prefix in reserved_prefixes:
        if name.startswith(prefix):
            raise Exception(f"names may not start with the reserved prefix {prefix!r} ({name})")


def list_duplicates(xs):
    seen, dups = set(), set()
    for x in xs:
        if x in seen:
            dups.add(x)
        seen.add(x)
    return list(dups)


# ---- tree utilities (trees are nested dicts; leaves are DT) -------------

def detach_tree(d: dict) -> dict:
    return {k: detach_tree(v) if isinstance(v, dict)
            else (DT(v.data.detach(), v.dims) if isinstance(v, DT) else v)
            for k, v in d.items()}


def tree_branches(tree: dict) -> dict:
    return {k: v for k, v in tree.items() if isinstance(v, dict)}


def tree_values(tree: dict) -> dict:
    return {k: v for k, v in tree.items() if not isinstance(v, dict)}


class KeyGen:
    """Random-number dispenser for one traversal: every request returns the
    same ``torch.Generator``, whose state advances with each draw, so a fixed
    program structure and a seeded generator give a fixed set of draws
    (``alan_tpu`` folds a JAX key instead; the two never give equal bits)."""

    def __init__(self, generator: torch.Generator | None):
        if generator is not None and not isinstance(generator, torch.Generator):
            raise TypeError(f"KeyGen takes a torch.Generator, not {type(generator)}")
        self.generator = generator

    def __call__(self) -> torch.Generator:
        if self.generator is None:
            raise ValueError("this draw needs a generator (injected noise "
                             "replaces the standard noise, not the permutations)")
        return self.generator


def seeded_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, i: int) -> int:
    """A seed for the ``i``-th stream of draws under ``seed``: the
    SplitMix64 finaliser of both, cut to 63 bits (the port's stand-in for
    ``jax.random.fold_in``; the two never give equal bits)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (int(i) + 1) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1
