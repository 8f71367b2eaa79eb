"""Learnable-parameter markers (counterpart of ``alan_tpu/ir/param.py``).

``OptParam`` marks a distribution argument as a gradient-learned parameter;
``QEMParam`` marks one learned by natural-gradient moment matching (QEM).
Initial values become entries in the BoundPlate's parameter state, on the
BoundPlate's device.
"""
from __future__ import annotations

import torch

from ..utils import Number


class Param:
    pass


def identity(x):
    return x


def _proc_init(init):
    if isinstance(init, Number):
        return torch.tensor(float(init))
    if not isinstance(init, torch.Tensor):
        raise TypeError(f"parameter init must be a number or a torch.Tensor, "
                        f"not {type(init)}")
    return init


class OptParam(Param):
    def __init__(self, init, transformation=None, ignore_platenames=(), name=None):
        self.init = _proc_init(init)
        self.trans = transformation if transformation is not None else identity
        self.ignore_platenames = ignore_platenames
        self.name = name


class QEMParam(Param):
    def __init__(self, init, ignore_platenames=(), name=None):
        self.init = _proc_init(init)
        self.trans = identity
        self.ignore_platenames = ignore_platenames
        self.name = name
