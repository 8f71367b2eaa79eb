"""Fused log-space matrix product:
``log(exp(A - rowmax) @ exp(B - colmax) + tiny) + rowmax + colmax``.

Counterpart of ``alan_tpu/ops/pallas_logmmexp.py`` (``logmmexp_fused``),
which ``ops.logmmexp.logmmexp`` takes for a float32 product whose
contracted dim is 128 or more: the chain steps of a timeseries at large K,
such as the AR(1) model at K = 1000.

On CUDA tensors the forward is hand-written for Hopper
(``alan_tpu_torch/csrc/logmmexp.cu``), replacing ``_kernel``
(``pallas_logmmexp.py:28``), in two launches:

* a pre-pass takes the row maxes of A and the column maxes of B over the
  whole contracted dim (the TPU kernel relies on that,
  ``pallas_logmmexp.py:44-47``) and writes every exponential once, times
  ``2**SCALE_BITS`` and split into TF32 hi and lo parts, into a scratch in
  the layout the tensor cores read (B transposed, rows and k padded with
  zeros); :func:`reference_prepass` is its plain version;
* the product kernel sums three TF32 tensor-core products a term (hi.lo,
  lo.hi, hi.hi: 3xTF32, f32 grade), each stage of ``BK`` k in a fresh sum
  added to an f32 accumulator, and writes ``log(. + tiny) + shifts``, so
  the product never reaches device memory.  :func:`emulate_product` repeats
  its arithmetic on the CPU, with the tensor cores' sums rounded toward
  zero.

The product is bound by operations: 2 M N K FLOP against M K + K N + M N
floats.  Its tiles are 128 rows by :func:`tile_n` columns.  The backward
stays in torch ops inside the ``autograd.Function``, as ``alan_tpu``'s is
plain jnp (``pallas_logmmexp.py:82-94``).

On CPU tensors the plain version, :func:`reference_logmmexp`, runs instead,
under ordinary autograd.  A CUDA tensor gets the kernel or an error.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .native import INT, PTR, check_status, load, ptr, stream

#: launches of the fused kernel (one per wrapper call that reaches the card,
#: pre-pass and product together; the plain version on the CPU does not
#: count)
LAUNCHES = 0

#: the kernel's layout (``csrc/logmmexp.cu``): rows of A a tile, k a stage
#: (and a fresh tensor-core sum), the power of two the exponentials carry
BM, BK, SCALE_BITS = 128, 32, 32
#: wgmma widths the product kernel is built for
TILE_WIDTHS = (64, 128)

_INT_MAX = 2 ** 31 - 1
_TINY = torch.finfo(torch.float32).tiny

_SIGNATURES = {
    "logmmexp_scratch_floats": [INT, INT, INT, INT, INT],
    "logmmexp_prepass": [PTR] * 5 + [INT] * 5 + [PTR],
    "logmmexp_product": [PTR] * 4 + [INT] * 5 + [PTR],
}


def _lib():
    lib = load("logmmexp", _SIGNATURES)
    lib.logmmexp_scratch_floats.restype = ctypes.c_longlong
    return lib


def _cdiv(a, b):
    return -(-a // b)


def tile_n(nb, M, N, sms):
    """Width of the product kernel's output tiles: 128, unless tiles of 64
    finish in fewer waves of blocks (one block an SM), counting a wave of
    width-128 tiles as twice one of width 64.  (2, 1000, 1000) on 132 SMs
    gives 128 blocks of 128 x 128; batch 1 would leave half the SMs idle,
    so it takes 128 blocks of 128 x 64."""
    def cost(bn):
        return _cdiv(nb * _cdiv(M, BM) * _cdiv(N, bn), sms) * bn
    return 64 if cost(64) < cost(128) else 128


def scratch_floats(nb, M, K, N, bn):
    """Floats of the pre-pass's scratch: hi and lo of A's (nb, M, K) and
    B's transposed (nb, N, K) exponentials, rows padded to whole tiles
    (BM of A, bn of B) and k to whole stages of BK."""
    kp = _cdiv(K, BK) * BK
    return 2 * nb * kp * (_cdiv(M, BM) * BM + _cdiv(N, bn) * bn)


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


# ---- the pre-pass's layout and plain version ------------------------------------

def tf32(x):
    """float32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``: the low 13 bits become 0."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _to_layout(E, R):
    """(nb, rows, K) float32 -> the kernel's flat scratch of it: for each
    batch, tile of R rows and stage of BK k, the hi part then the lo part,
    each in wgmma's K-major core layout (8 rows x 4 k contiguous, the k
    blocks of a row group next to each other, then the row groups)."""
    nb, rows, K = E.shape
    tiles, stages = _cdiv(rows, R), _cdiv(K, BK)
    E = F.pad(E, (0, stages * BK - K, 0, tiles * R - rows))
    hi = tf32(E)
    X = torch.stack([hi, tf32(E - hi)])
    X = X.reshape(2, nb, tiles, R // 8, 8, stages, BK // 4, 4)
    return X.permute(1, 2, 5, 0, 3, 6, 4, 7).reshape(-1)


def _from_layout(flat, nb, rows, K, R):
    """Inverse of :func:`_to_layout`: (hi, lo), each (nb, rows_pad, K_pad)."""
    tiles, stages = _cdiv(rows, R), _cdiv(K, BK)
    X = flat.reshape(nb, tiles, stages, 2, R // 8, BK // 4, 8, 4)
    X = X.permute(3, 0, 1, 4, 6, 2, 5, 7).reshape(2, nb, tiles * R, stages * BK)
    return X[0], X[1]


def reference_prepass(A, B, bn):
    """Plain version of the pre-pass on (nb, M, K) and (nb, K, N) float32:
    -> (a_max (nb, M), b_max (nb, N), scratch) with the scratch in the
    kernel's layout: A's ``exp(a - a_max) * 2**SCALE_BITS`` in tiles of BM
    rows, then B's, transposed, in tiles of ``bn``."""
    a_max, b_max = _shifts(A, B)
    scale = float(2 ** SCALE_BITS)
    Ea = torch.exp(A - a_max) * scale
    Eb = (torch.exp(B - b_max) * scale).transpose(1, 2)
    split = torch.cat([_to_layout(Ea, BM), _to_layout(Eb.contiguous(), bn)])
    return a_max[..., 0], b_max[:, 0], split


def split_parts(split, nb, M, K, N, bn):
    """The scratch as (a_hi, a_lo, b_hi, b_lo): (nb, M_pad, K_pad) and
    (nb, N_pad, K_pad), B transposed."""
    n_a = 2 * nb * _cdiv(M, BM) * BM * _cdiv(K, BK) * BK
    return (*_from_layout(split[:n_a], nb, M, K, BM),
            *_from_layout(split[n_a:], nb, N, K, bn))


def _round_to_zero(x):
    """float64 -> float32 rounded toward zero."""
    y = x.to(torch.float32)
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def emulate_product(a_max, b_max, split, nb, M, K, N, bn, chunk=BK):
    """The product kernel's arithmetic on the pre-pass's outputs, in plain
    torch: each k step of 8 adds its hi.lo, lo.hi and hi.hi products (each
    8-term dot exact) to a sum rounded toward zero, as the tensor cores
    round; each ``chunk`` of k starts a fresh sum, added to the f32
    accumulator; then ``log((acc + tiny 2^2s) 2^-2s) + a_max + b_max``."""
    ah, al, bh, bl = (t.double() for t in split_parts(split, nb, M, K, N, bn))
    acc = torch.zeros(ah.shape[:2] + bh.shape[1:2], dtype=torch.float32)
    for c0 in range(0, ah.shape[-1], chunk):
        t = torch.zeros_like(acc)
        for k in range(c0, min(c0 + chunk, ah.shape[-1]), 8):
            ks = slice(k, k + 8)
            for x, y in ((ah, bl), (al, bh), (ah, bh)):
                t = _round_to_zero(t.double() + x[..., ks] @ y[..., ks].transpose(1, 2))
        acc = acc + t
    s2 = float(2 ** (2 * SCALE_BITS))
    tiny = torch.tensor(_TINY * s2, dtype=torch.float32)
    unscale = torch.tensor(1.0 / s2, dtype=torch.float32)
    out = torch.log((acc[:, :M, :N] + tiny) * unscale)
    return out + a_max[:, :, None] + b_max[:, None, :]


# ---- the kernels -----------------------------------------------------------------

_SMS: dict = {}


def _sms(device):
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def _check(A, B):
    """Raise on what the kernels do not take; returns (nb, M, K, N)."""
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
    return nb, M, K, N


def _prepass(A, B, bn):
    """The pre-pass kernels: -> (a_max, b_max, scratch), as
    :func:`reference_prepass` gives them."""
    nb, M, K, N = _check(A, B)
    lib = _lib()
    kw = dict(device=A.device, dtype=torch.float32)
    a_max = torch.empty((nb, M), **kw)
    b_max = torch.empty((nb, N), **kw)
    split = torch.empty((lib.logmmexp_scratch_floats(nb, M, K, N, bn),), **kw)
    if split.numel() == 0:
        raise ValueError(f"nb, M, K, N = {nb, M, K, N}: out of the kernel's range")
    with torch.cuda.device(A.device):
        rc = lib.logmmexp_prepass(ptr(A), ptr(B), ptr(a_max), ptr(b_max), ptr(split),
                                  nb, M, K, N, bn, stream(A))
    check_status(rc, "logmmexp_prepass")
    return a_max, b_max, split


def _product(a_max, b_max, split, nb, M, K, N, bn):
    """The product kernel on the pre-pass's outputs: -> out (nb, M, N)."""
    out = torch.empty((nb, M, N), device=split.device, dtype=torch.float32)
    with torch.cuda.device(split.device):
        rc = _lib().logmmexp_product(ptr(split), ptr(a_max), ptr(b_max), ptr(out),
                                     nb, M, K, N, bn, stream(split))
    check_status(rc, "logmmexp_product")
    return out


def _launch(A, B):
    """The kernels on (nb, M, K) @ (nb, K, N) CUDA float32 operands."""
    global LAUNCHES
    nb, M, K, N = _check(A, B)
    bn = tile_n(nb, M, N, _sms(A.device))
    out = _product(*_prepass(A, B, bn), nb, M, K, N, bn)
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
    batch axes broadcast.  The kernels for CUDA tensors, the plain version
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
