"""Log-space matrix products for timeseries contraction (counterpart of
``alan_tpu/ops/logmmexp.py``).

The chain over T is reduced with a balanced pairwise tree, the same tree as
``alan_tpu`` (the odd remainder of a level is carried to the end of the
next).  Routes, as ``alan_tpu`` takes them (``logmmexp.py:15-101``):

* a float32 chain with T >= 2 and 2 <= K <= 100 runs the small-K chain
  kernels, several tree levels per launch as ``smallk_kernel.launch_plan``
  says (``ops/smallk_kernel.py``);
* otherwise each tree node whose contracted dim is 128 or more, in float32,
  runs the fused log-matmul kernel (``ops/logmmexp_kernel.py``);
* anything else takes the dense torch route: max-shifted exponentials and
  one ``torch.matmul``.

``ALAN_TPU_NO_SMALLK_CHAIN=1`` turns the small-K route off,
``ALAN_TPU_SMALLK_CHAIN=1`` forces it and ``ALAN_TPU_SMALLK_CHAIN_MAX_K``
moves its largest K (100), as in ``alan_tpu``; each is read at every call.
The TPU's own
limits on these routes (the VMEM footprint model, a batch that fills the
128 lanes) have no counterpart on the card: each kernel raises on what it
cannot take instead.  CPU tensors take the same routes, and each kernel
module gives them its plain version.

``logmmexp`` and ``chain_logmmexp`` count their model FLOPs from their
shapes (``perf.count_flops``), the same whichever route runs them, and
take sharded operands (``DTensor``s, under a ``MeshPlan``) over their
batch shards (``parallel.mesh.batch_local``).
"""
from __future__ import annotations

import math
import os

import torch

from .. import perf
from .logmmexp_kernel import logmmexp_fused, reference_logmmexp
from .smallk_kernel import chain_logmmexp_smallk


def _smallk_max_k() -> int:
    """Largest K of a chain routed to the small-K kernel."""
    return int(os.environ.get("ALAN_TPU_SMALLK_CHAIN_MAX_K", "100"))


def _count_logmmexp(nb, i, k, j):
    """Model FLOPs of ``nb`` log-matmuls (i, k) @ (k, j) (``alan_tpu``'s
    ``logmmexp.py:21-27``): the product, and shift, exp and log around it."""
    perf.count_flops(matmul=2.0 * nb * i * k * j,
                     elementwise=2.0 * nb * (i * k + k * j) + 2.0 * nb * i * j)


def count_chain(shape):
    """Count a chain of ``shape`` (..., T, K, K) level by level, as the tree
    runs it, whichever route (kernel launches of several levels, dense
    levels, shards of a sharded T) computes it."""
    if not perf.counting_active():
        return
    *batch, n, K, _ = shape
    nb = math.prod(batch)
    while n != 1:
        _count_logmmexp(nb * (n // 2), K, K, K)
        n = n // 2 + n % 2


def _logmmexp_local(A, B, allow_kernel: bool = True):
    if allow_kernel and A.shape[-1] >= 128 and A.dtype == torch.float32:
        return logmmexp_fused(A, B)
    return reference_logmmexp(A, B)


def logmmexp(A, B, allow_kernel: bool = True):
    """Batched log-space matmul: ``logsumexp_j(A[..., i, j] + B[..., j, k])``,
    max-shifted, with ``tiny`` inside the log."""
    batch = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    if perf.counting_active():
        _count_logmmexp(math.prod(batch), A.shape[-2], A.shape[-1], B.shape[-1])
    from ..parallel.mesh import batch_local, is_sharded
    if is_sharded(A) or is_sharded(B):
        A = A.expand(*batch, *A.shape[-2:])
        B = B.expand(*batch, *B.shape[-2:])
        return batch_local(lambda a, b: _logmmexp_local(a, b, allow_kernel),
                           [A, B], len(batch))
    return _logmmexp_local(A, B, allow_kernel)


def _use_smallk(ms) -> bool:
    """Route a chain to the small-K kernel (``alan_tpu``'s
    ``_use_smallk_lanes`` without its TPU layout limits)."""
    if os.environ.get("ALAN_TPU_NO_SMALLK_CHAIN"):
        return False
    if os.environ.get("ALAN_TPU_SMALLK_CHAIN"):
        return True
    return (ms.dtype == torch.float32 and 2 <= ms.shape[-1] <= _smallk_max_k()
            and ms.shape[-3] >= 2)


def _chain_local(ms):
    """The chain on one device's tensor, uncounted."""
    assert ms.shape[-1] == ms.shape[-2]
    if _use_smallk(ms):
        return chain_logmmexp_smallk(ms)
    T_axis = ms.dim() - 3
    while ms.shape[T_axis] != 1:
        n = ms.shape[T_axis]
        even = ms.narrow(T_axis, 0, n - n % 2)[..., ::2, :, :]
        odd = ms.narrow(T_axis, 1, n - 1)[..., ::2, :, :]
        prod = _logmmexp_local(even, odd)
        if n % 2 == 1:
            prod = torch.cat([prod, ms.narrow(T_axis, n - 1, 1)], dim=T_axis)
        ms = prod
    return ms.squeeze(T_axis)


def chain_logmmexp(ms):
    """Reduce ``ms[..., T, K, K]`` over T with log-space matmuls in a
    balanced pairwise tree, vectorised over the leading batch axes."""
    assert ms.shape[-1] == ms.shape[-2]
    count_chain(ms.shape)
    from ..parallel.mesh import batch_local, is_sharded
    if is_sharded(ms):
        return batch_local(_chain_local, [ms], ms.dim() - 3)
    return _chain_local(ms)
