"""Fused log-space matrix product:
``log(exp(A - rowmax) @ exp(B - colmax) + tiny) + rowmax + colmax``.

Counterpart of ``alan_tpu/ops/pallas_logmmexp.py`` (``logmmexp_fused``),
which ``ops.logmmexp.logmmexp`` takes for a float32 product whose
contracted dim is 128 or more: the chain steps of a timeseries at large K,
such as the AR(1) model at K = 1000.

On CUDA tensors the forward is a hand-written kernel for Hopper
(``alan_tpu_torch/csrc/logmmexp.cu``), replacing ``_kernel``
(``pallas_logmmexp.py:28``): a pre-pass takes the row maxes of A and the
column maxes of B over the whole contracted dim (the TPU kernel relies on
that, ``pallas_logmmexp.py:44-47``), then a tiled f32 GEMM applies
``exp(. - max)`` as it stages its operands and ``log(. + tiny) + shifts`` in
its epilogue, so the product never reaches device memory.  It is bound by
f32 operations at these sizes (2 M N K FLOP against M K + K N + M N
floats).  Its backward stays in torch ops inside the ``autograd.Function``,
as ``alan_tpu``'s is plain jnp (``pallas_logmmexp.py:82-94``).

On CPU tensors the plain version, :func:`reference_logmmexp`, runs instead,
under ordinary autograd.  A CUDA tensor gets the kernel or an error.
"""
from __future__ import annotations

import torch

from .native import INT, PTR, check_status, load, ptr, stream

#: launches of the fused kernel (one per wrapper call that reaches the card;
#: the plain version on the CPU does not count)
LAUNCHES = 0

_INT_MAX = 2 ** 31 - 1
_TINY = torch.finfo(torch.float32).tiny

_SIGNATURES = {
    "logmmexp_fwd": [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, PTR],
}


def _shifts(A, B):
    """Detached row maxes of A and column maxes of B, 0 where not finite."""
    a_max = torch.amax(A, dim=-1, keepdim=True).detach()
    b_max = torch.amax(B, dim=-2, keepdim=True).detach()
    a_max = torch.where(torch.isfinite(a_max), a_max, torch.zeros_like(a_max))
    b_max = torch.where(torch.isfinite(b_max), b_max, torch.zeros_like(b_max))
    return a_max, b_max


def reference_logmmexp(A, B):
    """Plain PyTorch version: ``logsumexp_j(A[..., i, j] + B[..., j, k])``
    through max-shifted exponentials and one matmul (``alan_tpu``'s jnp
    branch of ``ops.logmmexp.logmmexp``)."""
    a_max, b_max = _shifts(A, B)
    C = torch.matmul(torch.exp(A - a_max), torch.exp(B - b_max))
    return torch.log(C + torch.finfo(C.dtype).tiny) + a_max + b_max


def _launch(A, B):
    """The kernel on (nb, M, K) @ (nb, K, N) CUDA float32 operands."""
    global LAUNCHES
    for name, t in (("A", A), ("B", B)):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a float32 CUDA tensor, got "
                             f"{t.dtype} on {t.device}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-axis tensor")
    nb, M, K = A.shape
    if B.device != A.device or B.shape[0] != nb or B.shape[1] != K:
        raise ValueError(f"shapes disagree: A {tuple(A.shape)}, B {tuple(B.shape)}")
    N = B.shape[2]
    if min(nb, M, K, N) < 1 or max(nb, M, K, N) > _INT_MAX:
        raise ValueError(f"nb, M, K, N = {nb, M, K, N}: out of the kernel's range")
    kw = dict(device=A.device, dtype=torch.float32)
    out = torch.empty((nb, M, N), **kw)
    a_max = torch.empty((nb, M), **kw)
    b_max = torch.empty((nb, N), **kw)
    lib = load("logmmexp", _SIGNATURES)
    with torch.cuda.device(A.device):
        rc = lib.logmmexp_fwd(ptr(A), ptr(B), ptr(a_max), ptr(b_max), ptr(out),
                              nb, M, K, N, stream(A))
    check_status(rc, "logmmexp_fwd")
    LAUNCHES += 1
    return out


class _LogMMExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, B):
        ctx.save_for_backward(A, B)
        return _launch(A, B)

    @staticmethod
    def backward(ctx, g):
        A, B = ctx.saved_tensors
        a_max, b_max = _shifts(A, B)
        Ea, Eb = torch.exp(A - a_max), torch.exp(B - b_max)
        G = g / (torch.matmul(Ea, Eb) + _TINY)
        return (Ea * torch.matmul(G, Eb.transpose(-1, -2)),
                Eb * torch.matmul(Ea.transpose(-1, -2), G))


def logmmexp_fused(A, B):
    """A: (*batch, M, K), B: (*batch, K, N) -> (*batch, M, N), float32; the
    batch axes broadcast.  The kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if A.device != B.device:
        raise ValueError(f"A and B lie on different devices: {A.device}, {B.device}")
    if A.device.type == "cpu":
        return reference_logmmexp(A, B)
    if A.device.type != "cuda":
        raise ValueError(f"logmmexp runs on CUDA or the CPU, not {A.device}")
    batch = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    M, K = A.shape[-2:]
    N = B.shape[-1]
    A3 = A.expand(*batch, M, K).reshape(-1, M, K).contiguous()
    B3 = B.expand(*batch, K, N).reshape(-1, K, N).contiguous()
    return _LogMMExp.apply(A3, B3).reshape(*batch, M, N)
