"""Fused lazy low-rank K-contraction: the K^2 * plate tensor never exists.

Counterpart of ``alan_tpu/ops/pallas_lowrank.py``:

    out[s, p, j] = logsumexp_i( U[s, p, i, :] . V[s, j, :] + D[s, p, i] )

where ``i`` is the child latent's K-dim, ``j`` the parent K-dim(s), ``p`` the
kept plate dims, ``s`` shared batch dims and (U, V) the factored exp-family
operands from ``ops/lowrank.py``.

On CUDA tensors :func:`lowrank_logsumexp` runs hand-written kernels for
Hopper (``alan_tpu_torch/csrc/lowrank_lse.cu``):

* the forward kernel replaces ``_fwd_kernel`` (``pallas_lowrank.py:215``);
* the backward kernel replaces ``_bwd_kernel`` (``pallas_lowrank.py:298``).
  It recomputes ``gw = g * exp(U.V + D - out)`` and returns ``dD = sum_j gw``,
  ``dU = sum_j gw V`` and ``dV = sum_{p,i} gw U``, each only when autograd
  asks for it.  On the QEM path only D carries a gradient (the posterior
  source terms ride in D), so only dD is computed there.

What bounds them on the card: at the main-path shape (S=1, P=300, I=J=1000,
F=36) the forward is 2*P*I*J*F = 2.2e10 f32 FLOP plus 3e8 expf, the backward
up to three times that multiply-add work, against ~45 MB of operands, so
both are bound by f32 arithmetic, not by memory.  The kernels use plain f32
FMAs on the CUDA cores (f32-grade scores are required, see
``reference_lowrank_logsumexp``), keep one operand row per thread in
registers and broadcast the other from shared memory; the source note in
``lowrank_lse.cu`` has the details.  They take any S, P and F (a feature
axis wider than 40 is taken in chunks); the wrapper raises only on sizes
that do not fit the C interface's 32-bit ints.

On CPU tensors the plain version, :func:`reference_lowrank_logsumexp`, runs
instead, under ordinary autograd.  A CUDA tensor gets the kernel or an error.
"""
from __future__ import annotations

import ctypes

import torch

#: launches of the forward / backward kernels (one per wrapper call that
#: reaches the card; the plain version on the CPU does not count)
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

#: largest size the C interface's int arguments carry
_INT_MAX = 2 ** 31 - 1
#: dV partial-sum blocks aimed at: about four per SM of an H100 (132 SMs)
_DV_TARGET_BLOCKS = 4 * 132
#: longest (p, i) range one dV block sums
_DV_MAX_ROWS = 1024

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .._build import start_kernels
        lib = ctypes.CDLL(start_kernels().wait())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lowrank_lse_fwd.restype = i
        lib.lowrank_lse_fwd.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.lowrank_lse_bwd.restype = i
        lib.lowrank_lse_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i,
                                        i, i, i, i, i, p]
        _LIB = lib
    return _LIB


def _check_status(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA error {rc}")


def _check_operands(U, V, D):
    """Raise on anything the kernels do not take; returns (S, P, I, J, F)."""
    for name, t, nd in (("U", U, 4), ("V", V, 3), ("D", D, 3)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != nd:
            raise ValueError(f"{name} must have {nd} axes, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    S, P, I, F = U.shape
    if V.shape[0] != S or V.shape[2] != F or tuple(D.shape) != (S, P, I):
        raise ValueError(f"shapes disagree: U {tuple(U.shape)}, "
                         f"V {tuple(V.shape)}, D {tuple(D.shape)}")
    J = V.shape[1]
    if min(S, P, I, J, F) < 1:
        raise ValueError(f"empty operand: S,P,I,J,F = {S, P, I, J, F}")
    if max(S, P, I, J, F) > _INT_MAX:
        raise ValueError(f"S,P,I,J,F = {S, P, I, J, F}: a size above the "
                         f"kernels' 32-bit int arguments")
    for name, t in (("U", U), ("V", V), ("D", D)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if not (U.device == V.device == D.device):
        raise ValueError("U, V and D must lie on one device")
    return S, P, I, J, F


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else ctypes.c_void_p(0)


def _launch_fwd(U, V, D):
    global FWD_LAUNCHES
    S, P, I, J, F = _check_operands(U, V, D)
    lib = _lib()
    out = torch.empty((S, P, J), device=U.device, dtype=torch.float32)
    with torch.cuda.device(U.device):
        rc = lib.lowrank_lse_fwd(_ptr(U), _ptr(V), _ptr(D), _ptr(out),
                                 S, P, I, J, F, _stream(U))
    _check_status(rc, "lowrank_lse_fwd")
    FWD_LAUNCHES += 1
    return out


def dv_chunks(S, P, I, J) -> int:
    """Number of (p, i) ranges the dV reduction is split over: enough blocks
    to fill the card, ranges of at most _DV_MAX_ROWS rows (each range is one
    sequential f32 sum) and of at least one staged chunk of 32 rows."""
    j_tiles = -(-J // 128)
    fill = -(-_DV_TARGET_BLOCKS // (j_tiles * S))
    short = -(-(P * I) // _DV_MAX_ROWS)
    return int(max(1, min(max(fill, short), -(-(P * I) // 32))))


def _launch_bwd(U, V, D, out, g, want_dU: bool, want_dV: bool):
    """-> (dU or None, dD, dV or None)."""
    global BWD_LAUNCHES
    S, P, I, J, F = _check_operands(U, V, D)
    for name, t in (("out", out), ("g", g)):
        if (t.device != U.device or t.dtype != torch.float32
                or tuple(t.shape) != (S, P, J) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 (S, P, J) "
                             f"tensor on {U.device}")
    lib = _lib()
    kw = dict(device=U.device, dtype=torch.float32)
    dD = torch.empty((S, P, I), **kw)
    dU = torch.empty((S, P, I, F), **kw) if want_dU else None
    dV = scratch = None
    n_chunks = 0
    if want_dV:
        n_chunks = dv_chunks(S, P, I, J)
        dV = torch.empty((S, J, F), **kw)
        scratch = torch.empty((n_chunks, S, J, F), **kw)
    with torch.cuda.device(U.device):
        rc = lib.lowrank_lse_bwd(_ptr(U), _ptr(V), _ptr(D), _ptr(out), _ptr(g),
                                 _ptr(dU), _ptr(dD), _ptr(dV), _ptr(scratch),
                                 n_chunks, S, P, I, J, F, _stream(U))
    _check_status(rc, "lowrank_lse_bwd")
    BWD_LAUNCHES += 1
    return dU, dD, dV


class _LowRankLSE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, U, V, D):
        out = _launch_fwd(U, V, D)
        ctx.save_for_backward(U, V, D, out)
        return out

    @staticmethod
    def backward(ctx, g):
        U, V, D, out = ctx.saved_tensors
        need_U, need_V, _ = ctx.needs_input_grad
        dU, dD, dV = _launch_bwd(U, V, D, out, g.contiguous(), need_U, need_V)
        return dU, dV, dD


def reference_lowrank_logsumexp(U, V, D):
    """Plain PyTorch evaluation of the same contraction (materialises the
    cross tensor).  Counterpart of ``pallas_lowrank.py:409-416``: a dense
    f32 einsum, a detached max set to 0 where it is not finite, and
    ``log(sum(exp) + tiny)``."""
    A = torch.einsum("spif,sjf->spij", U, V) + D[..., None]
    m = torch.amax(A, dim=2).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    tiny = torch.finfo(torch.float32).tiny
    return torch.log(torch.exp(A - m[:, :, None, :]).sum(2) + tiny) + m


def lowrank_logsumexp(U, V, D):
    """``out[s,p,j] = logsumexp_i(U[s,p,i,:].V[s,j,:] + D[s,p,i])``.

    U: (S, P, I, F), V: (S, J, F), D: (S, P, I), float32, all on one device.
    CUDA tensors run the hand-written kernels (forward, and backward under
    autograd); CPU tensors run :func:`reference_lowrank_logsumexp`.
    """
    devices = {U.device, V.device, D.device}
    if len(devices) != 1:
        raise ValueError(f"U, V and D lie on different devices: {devices}")
    dev = U.device
    if dev.type == "cpu":
        return reference_lowrank_logsumexp(U, V, D)
    if dev.type != "cuda":
        raise ValueError(f"lowrank_logsumexp runs on CUDA or the CPU, not {dev}")
    return _LowRankLSE.apply(U, V, D)

