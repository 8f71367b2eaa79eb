"""Fused lazy low-rank K-contraction: the K^2 * plate tensor never exists.

Counterpart of ``alan_tpu/ops/pallas_lowrank.py``:

    out[s, p, j] = logsumexp_i( U[s, p, i, :] . V[s, j, :] + D[s, p, i] )

where ``i`` is the child latent's K-dim, ``j`` the parent K-dim(s), ``p`` the
kept plate dims, ``s`` shared batch dims and (U, V) the factored exp-family
operands from ``ops/lowrank.py``.

On CUDA tensors :func:`lowrank_logsumexp` runs hand-written kernels for
Hopper (``alan_tpu_torch/csrc/lowrank_lse.cu``):

* the forward kernel replaces ``_fwd_kernel`` (``pallas_lowrank.py:215``);
* the backward replaces ``_bwd_kernel`` (``pallas_lowrank.py:298``).  It
  recomputes ``gw = g * exp(U.V + D - out)`` and returns ``dD = sum_j gw``,
  ``dU = sum_j gw V`` and ``dV = sum_{p,i} gw U``, the last two only when
  autograd asks for them.  On the QEM path only D carries a gradient (the
  posterior source terms ride in D), so only dD is computed there; a VI
  step on grouped MovieLens asks for all three (z's draw sits in U, mu_z's
  and psi_z's in V).

What bounds them on the card: at the main-path shape (S=1, P=300, I=J=1000,
F=36) the forward is 2*P*I*J*F = 2.2e10 FLOP of score products plus 3e8
exponentials against ~46 MB of operands, and the dD backward the same.  The
scores must keep f32 grade (see ``reference_lowrank_logsumexp``), so every
kernel computes them on the tensor cores as three TF32 products per
multiply-add (3xTF32: hi/lo splits of both operands, the lo.lo product
dropped, ~2^-22 of each term), whose bound is 0.131 ms against 0.322 ms for
plain f32 FMAs.  The layout is FlashAttention-2's, with the logsumexp (or
the backward's weights) as the epilogue of each score tile, and the hi/lo
split is one pass before, into a scratch the wrapper allocates; the source
note in ``lowrank_lse.cu`` has the details.  The backward's scores are
bitwise the forward's, and its weights are normalised to the forward's
logsumexp before the f32 rounding of ``out`` (the forward also returns that
rounding): dD sums the weights of each score tile, and dU and dV, which
QEM never asks for and VI does, multiply the same weights by the streamed rows
(FlashAttention-2's P.V) on the CUDA cores.  The kernels take any S, P
and F (a feature axis too wide for shared memory is taken in chunks); the
wrapper raises only on sizes that do not fit the C interface's 32-bit ints.

On CPU tensors the plain version, :func:`reference_lowrank_logsumexp`, runs
instead, under ordinary autograd.  A CUDA tensor gets the kernel or an error.
"""
from __future__ import annotations

import ctypes

import torch

from .native import INT, PTR, check_status, load, ptr, stream

#: launches of the forward / backward kernels (one per wrapper call that
#: reaches the card; the plain version on the CPU does not count)
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
#: backward launches by mode: ``MODE_DD`` (dD alone), ``MODE_DU`` (dD and
#: dU) and ``MODE_DV`` (dV, with its reduce); one backward call launches
#: ``MODE_DD`` or ``MODE_DU``, and ``MODE_DV`` beside it where dV is asked for
DD_LAUNCHES = 0
DU_LAUNCHES = 0
DV_LAUNCHES = 0

#: largest size the C interface's int arguments carry
_INT_MAX = 2 ** 31 - 1

_SIGNATURES = {
    "lowrank_lse_split_floats": [INT, INT, INT, INT, INT],
    "lowrank_lse_fwd": [PTR] * 6 + [INT] * 5 + [PTR],
    "lowrank_lse_bwd": [PTR] * 11 + [INT] * 5 + [PTR],
}


def _lib():
    lib = load("lowrank_lse", _SIGNATURES)
    lib.lowrank_lse_split_floats.restype = ctypes.c_longlong
    return lib


def _split_scratch(lib, S, P, I, J, F, device):
    """Scratch for the kernels' hi/lo split of U and V."""
    n = lib.lowrank_lse_split_floats(S, P, I, J, F)
    return torch.empty((n,), device=device, dtype=torch.float32)


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


def _launch_fwd(U, V, D):
    """-> (out, rnd): rnd is the rounding of out's last f32 sum, with which
    the backward normalises its weights to the unrounded logsumexp."""
    global FWD_LAUNCHES
    S, P, I, J, F = _check_operands(U, V, D)
    lib = _lib()
    out = torch.empty((S, P, J), device=U.device, dtype=torch.float32)
    rnd = torch.empty_like(out)
    split = _split_scratch(lib, S, P, I, J, F, U.device)
    with torch.cuda.device(U.device):
        rc = lib.lowrank_lse_fwd(ptr(U), ptr(V), ptr(D), ptr(out), ptr(rnd),
                                 ptr(split), S, P, I, J, F, stream(U))
    check_status(rc, "lowrank_lse_fwd")
    FWD_LAUNCHES += 1
    return out, rnd


def _launch_bwd(U, V, D, out, rnd, g, want_dU: bool, want_dV: bool):
    """-> (dU or None, dD, dV or None); out and rnd from :func:`_launch_fwd`."""
    global BWD_LAUNCHES, DD_LAUNCHES, DU_LAUNCHES, DV_LAUNCHES
    S, P, I, J, F = _check_operands(U, V, D)
    for name, t in (("out", out), ("rnd", rnd), ("g", g)):
        if (t.device != U.device or t.dtype != torch.float32
                or tuple(t.shape) != (S, P, J) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 (S, P, J) "
                             f"tensor on {U.device}")
    lib = _lib()
    kw = dict(device=U.device, dtype=torch.float32)
    dD = torch.empty((S, P, I), **kw)
    dU = torch.empty((S, P, I, F), **kw) if want_dU else None
    dV = scratch = None
    if want_dV:
        dV = torch.empty((S, J, F), **kw)
        scratch = torch.empty((P, S, J, F), **kw)    # dV's sum over each p
    split = _split_scratch(lib, S, P, I, J, F, U.device)
    with torch.cuda.device(U.device):
        rc = lib.lowrank_lse_bwd(ptr(U), ptr(V), ptr(D), ptr(out), ptr(rnd),
                                 ptr(g), ptr(dU), ptr(dD), ptr(dV), ptr(scratch),
                                 ptr(split), S, P, I, J, F, stream(U))
    check_status(rc, "lowrank_lse_bwd")
    BWD_LAUNCHES += 1
    if want_dU:
        DU_LAUNCHES += 1
    else:
        DD_LAUNCHES += 1
    if want_dV:
        DV_LAUNCHES += 1
    return dU, dD, dV


class _LowRankLSE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, U, V, D):
        out, rnd = _launch_fwd(U, V, D)
        ctx.save_for_backward(U, V, D, out, rnd)
        return out

    @staticmethod
    def backward(ctx, g):
        U, V, D, out, rnd = ctx.saved_tensors
        need_U, need_V, _ = ctx.needs_input_grad
        dU, dD, dV = _launch_bwd(U, V, D, out, rnd, g.contiguous(), need_U, need_V)
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

