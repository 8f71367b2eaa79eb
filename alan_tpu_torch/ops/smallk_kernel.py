"""Small-K chain log-matmul: a balanced pairwise tree over T of
``out[i, k] = logsumexp_j(A[i, j] + B[j, k])`` for many independent chains
of small (K x K) operators.

Counterpart of ``alan_tpu/ops/pallas_smallk.py`` (``chain_logmmexp_lanes``).
Covid's ``log_infected`` chain is ``nRs * K_npis = 2760`` chains of T = 109
operators of 30 x 30 each at K = 30: one tree level is thousands of tiny
products, which a batched matmul library call serves poorly.

On CUDA tensors each tree level is one launch of a hand-written kernel for
Hopper (``alan_tpu_torch/csrc/smallk_logmmexp.cu``):

* the forward kernel replaces ``_fwd_kernel`` (``pallas_smallk.py:66``);
* the backward kernel replaces ``_bwd_kernel`` (``pallas_smallk.py:80``):
  it recomputes the product and returns
  ``dA = ea * ((g / (c + tiny)) . eb^T)`` and ``dB = eb * (ea^T . (g / (c + tiny)))``.

A level works on the tree's own layout ``(nB, n, K, K)``: the pair
``(2l, 2l + 1)`` lies side by side, so the kernel reads it in place, and the
odd remainder of a level is one copy.  At covid's chain both kernels are
bound by memory (5 FLOP per byte at K = 30); the source note in
``smallk_logmmexp.cu`` has the design.  They take 1 <= K <= 128
(:data:`MAX_K`, the backward's shared memory) and raise on anything else.

On CPU tensors the plain version, :func:`reference_level`, runs instead,
under ordinary autograd: the same tree order and the same finite-guarded
shifts and ``log(c + tiny)`` as ``ops.logmmexp.logmmexp``.  A CUDA tensor
gets the kernel or an error.
"""
from __future__ import annotations

import torch

from .native import INT, PTR, check_status, load, ptr, stream

#: launches of the forward / backward kernel (one per tree level that
#: reaches the card; the plain version on the CPU does not count)
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

#: largest K the kernels take (the backward holds 3 K^2 floats in shared
#: memory: 197 KB at K = 128 of the 227 KB a block may use)
MAX_K = 128
_INT_MAX = 2 ** 31 - 1
_TINY = torch.finfo(torch.float32).tiny

_SIGNATURES = {
    "smallk_logmmexp_fwd": [PTR, PTR, INT, INT, INT, PTR],
    "smallk_logmmexp_bwd": [PTR, PTR, PTR, INT, INT, INT, PTR],
}


def _check_level(x):
    """Raise on a level the kernels do not take; returns (nB, n, K)."""
    if x.device.type != "cuda":
        raise ValueError(f"the small-K kernels take CUDA tensors, not {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"the small-K kernels take float32, not {x.dtype}")
    if x.dim() != 4 or x.shape[2] != x.shape[3]:
        raise ValueError(f"a level is (nB, n, K, K), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("a level must be contiguous")
    nB, n, K, _ = x.shape
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K}: the small-K kernels take 1 <= K <= {MAX_K}")
    if n < 2 or nB < 1:
        raise ValueError(f"a level needs n >= 2 operators and a chain, got "
                         f"nB={nB}, n={n}")
    if nB * (n // 2) > _INT_MAX:
        raise ValueError(f"nB * n/2 = {nB * (n // 2)} blocks: above the grid")
    return nB, n, K


def _launch_fwd(x):
    """One level forward on the card: (nB, n, K, K) -> (nB, ceil(n/2), K, K)."""
    global FWD_LAUNCHES
    nB, n, K = _check_level(x)
    out = torch.empty((nB, (n + 1) // 2, K, K), device=x.device,
                      dtype=torch.float32)
    lib = load("smallk_logmmexp", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.smallk_logmmexp_fwd(ptr(x), ptr(out), nB, n, K, stream(x))
    check_status(rc, "smallk_logmmexp_fwd")
    FWD_LAUNCHES += 1
    if n % 2:
        out[:, -1].copy_(x[:, -1])
    return out


def _launch_bwd(x, g):
    """One level backward on the card: the gradient of the level's input
    from ``g``, the gradient of its output."""
    global BWD_LAUNCHES
    nB, n, K = _check_level(x)
    if (g.device != x.device or g.dtype != torch.float32 or not g.is_contiguous()
            or tuple(g.shape) != (nB, (n + 1) // 2, K, K)):
        raise ValueError(f"g must be a contiguous float32 {(nB, (n + 1) // 2, K, K)} "
                         f"tensor on {x.device}, got {tuple(g.shape)}")
    dx = torch.empty_like(x)
    lib = load("smallk_logmmexp", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.smallk_logmmexp_bwd(ptr(x), ptr(g), ptr(dx), nB, n, K, stream(x))
    check_status(rc, "smallk_logmmexp_bwd")
    BWD_LAUNCHES += 1
    if n % 2:
        dx[:, -1].copy_(g[:, -1])
    return dx


class _Level(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _launch_fwd(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _launch_bwd(x, g.contiguous())


def reference_level(x):
    """Plain PyTorch version of one level (``ops.logmmexp.logmmexp`` on the
    even and odd operators, the odd remainder carried over)."""
    n = x.shape[1]
    A, B = x[:, 0:n - n % 2:2], x[:, 1:n:2]
    a_max = torch.amax(A, dim=-1, keepdim=True).detach()
    b_max = torch.amax(B, dim=-2, keepdim=True).detach()
    a_max = torch.where(torch.isfinite(a_max), a_max, torch.zeros_like(a_max))
    b_max = torch.where(torch.isfinite(b_max), b_max, torch.zeros_like(b_max))
    C = torch.matmul(torch.exp(A - a_max), torch.exp(B - b_max))
    out = torch.log(C + _TINY) + a_max + b_max
    if n % 2:
        out = torch.cat([out, x[:, n - 1:]], dim=1)
    return out


def logmmexp_level(x):
    """One tree level of (nB, n, K, K): the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return reference_level(x)
    if x.device.type != "cuda":
        raise ValueError(f"the small-K chain runs on CUDA or the CPU, not {x.device}")
    return _Level.apply(x.contiguous())


def chain_logmmexp_smallk(ms):
    """Reduce ``ms[..., T, K, K]`` over T with the balanced pairwise tree of
    ``ops.logmmexp.chain_logmmexp``, one :func:`logmmexp_level` per level."""
    *batch, T, K, _ = ms.shape
    if ms.dtype != torch.float32:
        raise TypeError(f"the small-K chain takes float32, got {ms.dtype}")
    x = ms.reshape(-1, T, K, K)
    while x.shape[1] != 1:
        x = logmmexp_level(x)
    return x[:, 0].reshape(*batch, K, K)
