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

The joint-shift repair.  The separate shifts lose an entry whose row of A
and column of B peak at different k: every term underflows, ``c`` is 0,
the value is ``log(tiny)`` plus the shifts and the gradient 0.  An entry
whose ``c`` falls below :data:`JOINT_BELOW` (2^-60: terms below ``tiny``
are then under 2^-66 of the sum) and whose joint max ``max_k(a_ik +
b_kj)`` is finite is recomputed with the joint shift, against its largest
term (:func:`joint_repair`); every other entry is bitwise what it was.  On the
card a fix-up kernel follows the product: it reads ``log(c + tiny)`` back
from the output (flagged below ``ln 2^-60``), lists each tile's flagged
entries and walks each once (its first argmax and the sum together).
Where a gradient is wanted it also keeps each flagged entry's record (the
reference terms, ``-log2`` of the sum and the argmax t*; by row and by
column) and bit masks of the flagged entries by row and by column
(:func:`fixup_masks`); the backward's torch ops leave the flagged entries
out and a second fix-up kernel adds their gradients, ``g exp(a_ik + b_kj -
out_ij)``, from what was kept, in a fixed order (no atomics).
:func:`reference_fixup_state` and :func:`reference_fixup_bwd` are their
plain versions.

On CPU tensors the plain version, :func:`reference_logmmexp`, runs instead,
under ordinary autograd.  A CUDA tensor gets the kernel or an error.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .native import INT, PTR, check_status, load, ptr, stream

#: launches of the fused kernel (one per wrapper call that reaches the card,
#: pre-pass, product and fix-up together; the plain version on the CPU does
#: not count) and of the backward's fix-up kernel
LAUNCHES = 0
BWD_LAUNCHES = 0

#: ``c`` below which an entry takes the joint shift (the fused kernel's
#: fix-up compares ``log(c + tiny)`` with ``ln 2^-60``)
JOINT_BELOW = 2.0 ** -60
#: where set to a one-element int64 tensor, the plain versions and the
#: fix-up kernels of this module and ``smallk_kernel`` add to it the
#: entries that took the joint shift (the kernels only on its device)
JOINT_COUNT = None

#: the kernel's layout (``csrc/logmmexp.cu``): rows of A a tile, k a stage
#: (and a fresh tensor-core sum), the power of two the exponentials carry
BM, BK, SCALE_BITS = 128, 32, 32
#: wgmma widths the product kernel is built for
TILE_WIDTHS = (64, 128)
#: the fix-ups' tiles: rows and columns of the entries a forward block lists
FIX_TM, FIX_TN = 64, 32

_INT_MAX = 2 ** 31 - 1
_TINY = torch.finfo(torch.float32).tiny

_SIGNATURES = {
    "logmmexp_scratch_floats": [INT, INT, INT, INT, INT],
    "logmmexp_prepass": [PTR] * 5 + [INT] * 5 + [PTR],
    "logmmexp_product": [PTR] * 4 + [INT] * 5 + [PTR],
    "logmmexp_fixup": [PTR] * 11 + [INT] * 4 + [PTR],
    "logmmexp_fixup_bwd": [PTR] * 10 + [INT] * 4 + [PTR],
    "logmmexp_fixup_mask_words": [INT] * 4,
}


def _lib():
    lib = load("logmmexp", _SIGNATURES)
    lib.logmmexp_scratch_floats.restype = ctypes.c_longlong
    lib.logmmexp_fixup_mask_words.restype = ctypes.c_longlong
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


def count_joint(n):
    """Add ``n`` (a tensor or an int) to :data:`JOINT_COUNT` where it is set."""
    if JOINT_COUNT is not None:
        JOINT_COUNT.add_(torch.as_tensor(n, device=JOINT_COUNT.device).to(torch.int64))


def joint_counter(device):
    """:data:`JOINT_COUNT` for a kernel on ``device``, else None."""
    if JOINT_COUNT is not None and JOINT_COUNT.device == torch.device(device):
        return JOINT_COUNT
    return None


#: elements of the (rows, K, N) cross sums that the plain repair forms at once
_JOINT_CHUNK = 1 << 24


def _joint_rows(a, b):
    """Rows ``a`` (r, K) against their operators ``b`` (r, K, N): the
    reference term of each entry, the first argmax t* of ``a_t + b_tn`` (al
    = a_t*, be = b_t*n), the exponents ``e = (a_t - al) + (b_tn - be)``
    (r, K, N), whether the max is finite, and t* (r, N)."""
    m, t = (a[:, :, None] + b).max(dim=1)
    finite = torch.isfinite(m)
    al = torch.where(finite, a.gather(1, t), 0.0)
    be = torch.where(finite, b.gather(1, t[:, None, :])[:, 0], 0.0)
    return al, be, (a[:, :, None] - al[:, None, :]) + (b - be[:, None, :]), finite, t


class _JointValues(torch.autograd.Function):
    """The joint-shift value of every entry of ``A @ B`` in log space, A
    (n, M, K) and B (n, K, N): ``al + be + log sum_t exp(e)``; rows taken
    in chunks of at most :data:`_JOINT_CHUNK` cross-sum elements, in the
    backward again, so that no (n, M, K, N) tensor is ever held.  ->
    (values, finite), values 0 where no term is finite."""

    @staticmethod
    def forward(ctx, A, B):
        n, M, K = A.shape
        N = B.shape[-1]
        rows, pair = A.reshape(n * M, K), torch.arange(n, device=A.device).repeat_interleave(M)
        vals = torch.empty((n * M, N), dtype=A.dtype, device=A.device)
        finite = torch.empty((n * M, N), dtype=torch.bool, device=A.device)
        step = max(1, _JOINT_CHUNK // (K * N))
        for r in range(0, n * M, step):
            al, be, e, fin, _ = _joint_rows(rows[r:r + step], B[pair[r:r + step]])
            vals[r:r + step] = torch.where(fin, al + be + torch.log(torch.exp(e).sum(1)), 0.0)
            finite[r:r + step] = fin
        ctx.save_for_backward(A, B)
        ctx.mark_non_differentiable(finite)
        return vals.reshape(n, M, N), finite.reshape(n, M, N)

    @staticmethod
    def backward(ctx, g, _):
        A, B = ctx.saved_tensors
        n, M, K = A.shape
        N = B.shape[-1]
        rows, pair = A.reshape(n * M, K), torch.arange(n, device=A.device).repeat_interleave(M)
        g = g.reshape(n * M, N)
        dA, dB = torch.zeros_like(rows), torch.zeros_like(B)
        step = max(1, _JOINT_CHUNK // (K * N))
        for r in range(0, n * M, step):
            _, _, e, fin, _ = _joint_rows(rows[r:r + step], B[pair[r:r + step]])
            L = torch.where(fin, torch.log(torch.exp(e).sum(1)), 0.0)
            w = torch.where(fin[:, None, :], torch.exp(e - L[:, None, :]), 0.0)
            w = w * g[r:r + step, None, :]                      # (r, K, N)
            dA[r:r + step] = w.sum(2)
            dB.index_add_(0, pair[r:r + step], w)
        return dA.reshape(n, M, K), dB


def joint_repair(out, C, A, B):
    """``out = log(C + tiny) + shifts`` of ``A @ B`` in log space, with every
    entry whose ``C`` is below :data:`JOINT_BELOW` and whose joint max is
    finite recomputed with the joint shift, against its largest term
    (``al + be + log sum_t exp((a_t - al) + (b_t - be))``, the shifts held
    constant: the differences stay exact where the terms that matter are
    close, however large the log-densities).  The batch axes of A and B
    broadcast; only products with a flagged entry are recomputed, and the
    plain version synchronises with the host to find them.
    Differentiable; unflagged entries are bitwise ``out``'s, value and
    gradient.  A flagged entry with no finite term keeps its value and
    passes no gradient, as on the card: through ``log(c + tiny)`` its
    ``g / tiny`` summed over a row or column can overflow, and times the
    zero exponentials it meets gives NaN."""
    flag = C.detach() < JOINT_BELOW
    if not bool(flag.any()):
        return out
    *batch, M, N = out.shape
    K = A.shape[-1]
    A3 = A.expand(*batch, M, K).reshape(-1, M, K)
    B3 = B.expand(*batch, K, N).reshape(-1, K, N)
    f3, out3 = flag.reshape(-1, M, N), out.reshape(-1, M, N)
    pairs = f3.flatten(1).any(1).nonzero()[:, 0]
    vals, finite = _JointValues.apply(A3[pairs], B3[pairs])
    take = f3[pairs] & finite
    count_joint(take.sum())
    old = out3[pairs]
    new = torch.where(take, vals, torch.where(f3[pairs], old.detach(), old))
    out3 = out3.index_put((pairs,), new)
    return out3.reshape(out.shape)


def reference_logmmexp(A, B):
    """Plain PyTorch version: ``logsumexp_j(A[..., i, j] + B[..., j, k])``
    through max-shifted exponentials and one matmul (``alan_tpu``'s jnp
    branch of ``ops.logmmexp.logmmexp``), then :func:`joint_repair`."""
    a_max, b_max = _shifts(A, B)
    C = torch.matmul(torch.exp(A - a_max), torch.exp(B - b_max))
    out = torch.log(C + torch.finfo(C.dtype).tiny) + a_max + b_max
    return joint_repair(out, C, A, B)


# ---- what the fix-ups keep for the backward, and its plain versions ----------------

_LOG2E = 1.4426950408889634


def fixup_tiles(M, N):
    """(row tiles, column tiles) of the fix-ups: :data:`FIX_TM` rows by
    :data:`FIX_TN` columns."""
    return _cdiv(M, FIX_TM), _cdiv(N, FIX_TN)


def fixup_mask_words(nb, M, N, cols):
    """Words of the kept masks: by row (``cols`` false; 32 bits each, nb M
    ceil(N / FIX_TN)) or by column (64 bits each, nb N ceil(M / FIX_TM))."""
    mt, nt = fixup_tiles(M, N)
    return nb * N * mt if cols else nb * M * nt


def fixup_masks(flags):
    """The fix-up's masks of the flagged entries (nb, M, N) bool: by row,
    bit c of word [b, i, J] is ``flags[b, i, FIX_TN J + c]`` (int32, (nb,
    M, ceil(N / FIX_TN))); by column, bit r of word [b, j, I] is
    ``flags[b, FIX_TM I + r, j]`` (int64, (nb, N, ceil(M / FIX_TM)))."""
    nb, M, N = flags.shape
    mt, nt = fixup_tiles(M, N)
    f = F.pad(flags.to(torch.int64), (0, nt * FIX_TN - N, 0, mt * FIX_TM - M))
    bits = lambda n: torch.arange(n, device=flags.device)
    rows = (f.reshape(nb, mt * FIX_TM, nt, FIX_TN) << bits(FIX_TN)).sum(-1)
    cols = (f.transpose(1, 2).reshape(nb, nt * FIX_TN, mt, FIX_TM) << bits(FIX_TM)).sum(-1)
    return rows[:, :M].to(torch.int32), cols[:, :N]


def reference_fixup_state(A, B, flags):
    """Plain version of the record the forward fix-up keeps, where a
    gradient is wanted, for (nb, M, K) @ (nb, K, N) float32 and its flags:
    (nb, M, N, 4) float32 holding at each flagged entry (al, be,
    -log2(sum), t*), with t* the first argmax of ``a_t + b_t`` (as int32
    bits), al = a_t*, be = b_t* and sum = ``sum_t exp((a_t - al) + (b_t -
    be))``; (0, 0, -inf, 0) where no term is finite, 0 at the other
    entries.  Rows in chunks, as :class:`_JointValues` takes them."""
    nb, M, K = A.shape
    N = B.shape[2]
    rec = torch.zeros((nb * M, N, 4), dtype=torch.float32, device=A.device)
    rows, pair = A.reshape(nb * M, K), torch.arange(nb, device=A.device).repeat_interleave(M)
    f = flags.reshape(nb * M, N)
    step = max(1, _JOINT_CHUNK // (K * N))
    for r in range(0, nb * M, step):
        al, be, e, fin, t = _joint_rows(rows[r:r + step], B[pair[r:r + step]])
        nl = torch.where(fin, -torch.log2(torch.exp(e).sum(1)), -torch.inf)
        t = torch.where(fin, t, 0).to(torch.int32).view(torch.float32)
        rec[r:r + step] = torch.where(f[r:r + step, :, None],
                                      torch.stack([al, be, nl, t], -1), 0.0)
    return rec.reshape(nb, M, N, 4)


def reference_fixup_bwd(A, B, g, rec, flags):
    """Plain version of the backward fix-up: the gradients of the flagged
    entries from their records (:func:`reference_fixup_state`), ``w_ijt =
    g_ij 2^(((a_it - al) + (b_tj - be)) log2(e) - log2(sum))``, 0 where no
    term is finite: -> (dA, dB) of those entries alone."""
    nb, M, K = A.shape
    N = B.shape[2]
    rows, pair = A.reshape(nb * M, K), torch.arange(nb, device=A.device).repeat_interleave(M)
    R, g = rec.reshape(nb * M, N, 4), g.reshape(nb * M, N)
    take = flags.reshape(nb * M, N) & (R[..., 2] > -torch.inf) & (g != 0)
    dA, dB = torch.zeros_like(rows), torch.zeros_like(B)
    step = max(1, _JOINT_CHUNK // (K * N))
    for r in range(0, nb * M, step):
        al, be, nl = (R[r:r + step, None, :, c] for c in range(3))
        e = (rows[r:r + step, :, None] - al) + (B[pair[r:r + step]] - be)
        w = torch.where(take[r:r + step, None, :],
                        g[r:r + step, None, :] * torch.exp2(e * _LOG2E + nl), 0.0)
        dA[r:r + step] = w.sum(2)
        dB.index_add_(0, pair[r:r + step], w)
    return dA.reshape(nb, M, K), dB


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


def _kept_state(nb, M, N, device):
    """Empty buffers for what the forward fix-up keeps for the backward:
    (records by row (nb, M, N, 4) and by column (nb, N, M, 4) float32, row
    masks int32, column masks int64)."""
    return (torch.empty((nb, M, N, 4), device=device, dtype=torch.float32),
            torch.empty((nb, N, M, 4), device=device, dtype=torch.float32),
            torch.empty((fixup_mask_words(nb, M, N, False),), device=device,
                        dtype=torch.int32),
            torch.empty((fixup_mask_words(nb, M, N, True),), device=device,
                        dtype=torch.int64))


def _fixup(A, B, a_max, b_max, out, save=False):
    """The forward fix-up kernel: out's flagged entries recomputed in place;
    returns the flags (nb, M, N) bool and, where ``save`` is set, what the
    backward fix-up takes (:func:`_kept_state`), else None."""
    nb, M, K = A.shape
    N = B.shape[2]
    flags = torch.empty((nb, M, N), device=A.device, dtype=torch.bool)
    kept = _kept_state(nb, M, N, A.device) if save else None
    rec, recT, rows, cols = kept if save else (None,) * 4
    with torch.cuda.device(A.device):
        rc = _lib().logmmexp_fixup(ptr(A), ptr(B), ptr(a_max), ptr(b_max), ptr(out),
                                   ptr(flags), ptr(joint_counter(A.device)), ptr(rec),
                                   ptr(recT), ptr(rows), ptr(cols), nb, M, K, N, stream(A))
    check_status(rc, "logmmexp_fixup")
    return flags, kept


def _launch(A, B, save=False):
    """The kernels on (nb, M, K) @ (nb, K, N) CUDA float32 operands: ->
    (out, the fix-up's flags, what it kept for the backward or None)."""
    global LAUNCHES
    nb, M, K, N = _check(A, B)
    bn = tile_n(nb, M, N, _sms(A.device))
    a_max, b_max, split = _prepass(A, B, bn)
    out = _product(a_max, b_max, split, nb, M, K, N, bn)
    flags, kept = _fixup(A, B, a_max, b_max, out, save)
    LAUNCHES += 1
    return out, flags, kept


def _fixup_bwd(A, B, g, kept, dA, dB):
    """The backward fix-up kernel: the flagged entries' gradients, from
    what the forward fix-up kept, added to dA and dB in place."""
    if kept is None:
        raise ValueError("the backward fix-up takes what the forward fix-up kept")
    nb, M, K = A.shape
    rec, recT, rows, cols = kept
    gT = g.transpose(1, 2).contiguous()
    with torch.cuda.device(A.device):
        rc = _lib().logmmexp_fixup_bwd(ptr(A), ptr(B), ptr(g), ptr(gT), ptr(rec), ptr(recT),
                                       ptr(rows), ptr(cols), ptr(dA), ptr(dB), nb, M, K,
                                       B.shape[2], stream(A))
    check_status(rc, "logmmexp_fixup_bwd")


def _launch_bwd(A, B, flags, kept, g):
    """The backward on the card: the unflagged entries' gradients by torch
    ops (``alan_tpu``'s plain jnp backward, ``pallas_logmmexp.py:82-94``),
    the flagged entries' added by the fix-up kernel."""
    global BWD_LAUNCHES
    a_max, b_max = _shifts(A, B)
    Ea, Eb = torch.exp(A - a_max), torch.exp(B - b_max)
    G = (g / (torch.matmul(Ea, Eb) + _TINY)).masked_fill(flags, 0.0)
    dA = Ea * torch.matmul(G, Eb.transpose(-1, -2))
    dB = Eb * torch.matmul(Ea.transpose(-1, -2), G)
    _fixup_bwd(A, B, g, kept, dA, dB)
    BWD_LAUNCHES += 1
    return dA, dB


class _LogMMExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, B):
        out, flags, kept = _launch(A, B, save=any(ctx.needs_input_grad))
        ctx.save_for_backward(A, B, flags, *(kept or ()))
        return out

    @staticmethod
    def backward(ctx, g):
        A, B, flags, *kept = ctx.saved_tensors
        return _launch_bwd(A, B, flags, tuple(kept) or None, g.contiguous())


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
