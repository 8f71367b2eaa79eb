"""Small-K chain log-matmul: a balanced pairwise tree over T of
``out[i, k] = logsumexp_j(A[i, j] + B[j, k])`` for many independent chains
of small (K x K) operators.

Counterpart of ``alan_tpu/ops/pallas_smallk.py`` (``chain_logmmexp_lanes``).
Covid's ``log_infected`` chain is ``nRs * K_npis = 2760`` chains of T = 109
operators of 30 x 30 each at K = 30: one tree level is thousands of tiny
products, which a batched matmul library call serves poorly.

On CUDA tensors the tree runs as a few launches of hand-written kernels for
Hopper (``alan_tpu_torch/csrc/smallk_logmmexp.cu``), each taking m levels
at once: a block reduces an aligned segment of ``2^m`` consecutive operators
of one chain in shared memory, so a launch turns ``(nB, n, K, K)`` into
``(nB, ceil(n / 2^m), K, K)``.  Because the tree carries an odd remainder
to the end of the next level, aligned segments perform exactly the pair
products of m single levels, in the same order.  :func:`launch_plan` picks
m for each launch from T and K (covid: 109 -> 14 -> 2 -> 1, three launches
instead of seven levels):

* the forward kernel replaces ``_fwd_kernel`` (``pallas_smallk.py:66``);
* the backward kernel replaces ``_bwd_kernel`` (``pallas_smallk.py:80``):
  it recomputes the segment's inner levels and returns
  ``dA = ea * ((g / (c + tiny)) . eb^T)`` and ``dB = eb * (ea^T . (g / (c + tiny)))``
  level by level down to the segment's operators.

The joint-shift repair (``logmmexp_kernel.joint_repair``).  An entry whose
``c`` falls below ``JOINT_BELOW`` (2^-60) and whose joint max is finite
takes the joint shift, at every tree level, inner ones included: covid's
peaked transitions otherwise underflow to ``log(tiny)`` with a gradient of
0.  On the card each fast kernel raises a flag per segment job where an
entry fell below the threshold and stops work on that segment; a fix-up
kernel, launched after it every time, reduces only the flagged segments,
from the launch's input, in register tiles (forward), or takes their
gradients from the joint weights ``exp(a_ik + b_kj - out_ij)``, rebuilt
from what the forward fix-up kept (backward).
Unflagged segments are bitwise what the fast kernels give.

Each launch is one :class:`torch.autograd.Function` that saves its own
input, its flags (an int a segment), which the backward's fast kernel
takes to skip the flagged segments, and, where a gradient is wanted, what
the forward fix-up computed for the backward's (:func:`fixup_saved`
floats a segment: the inner nodes, each entry's t* and log-sum), so that
the backward recomputes nothing.  The kernels take 1 <= K <= 128 (:data:`MAX_K`, the backward's
shared memory at m = 1) and an m whose fix-up layouts fit (every m that
:func:`launch_plan` picks), and raise on anything else; the source note in
``smallk_logmmexp.cu`` has the design, :func:`fixup_layout` the fix-ups'
shared memory.

On CPU tensors the plain version, :func:`reference_segment`, runs the same
launch plan under ordinary autograd: the same tree order, the same
finite-guarded shifts and ``log(c + tiny)`` as ``ops.logmmexp.logmmexp``,
and the same joint-shift repair.
A CUDA tensor gets the kernels or an error.
"""
from __future__ import annotations

import torch

from .logmmexp_kernel import joint_counter, joint_repair
from .native import INT, PTR, check_status, load, ptr, stream

#: launches of the forward / backward kernel, each with its fix-up (one per
#: entry of the launch plan that reaches the card; the plain version on the
#: CPU does not count)
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

#: largest K the kernels take (the backward at m = 1 then holds three
#: operators in the direct layout: 198 KB of the 227 KB a block may use)
MAX_K = 128
#: most tree levels one launch takes (segments of at most 32 operators)
MAX_M = 5
_INT_MAX = 2 ** 31 - 1
_TINY = torch.finfo(torch.float32).tiny

#: the H100's shared memory: what a block may use, what an SM has, and what
#: the runtime keeps back per block
SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024
_HEAD, _PAD = 4, 8   # floats before and after a kernel's layout (smallk_logmmexp.cu)

_SIGNATURES = {
    "smallk_segment_fwd": [PTR, PTR, PTR, INT, INT, INT, INT, INT, PTR],
    "smallk_segment_bwd": [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, PTR],
    "smallk_fixup_fwd": [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, PTR],
    "smallk_fixup_bwd": [PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, PTR],
    "smallk_smem_bytes": [INT, INT, INT, INT],
    "smallk_fixup_smem_bytes": [INT, INT, INT, PTR],
    "smallk_fixup_saved_floats": [INT, INT],
    "smallk_log_mismatches": [INT, INT, PTR, PTR],
}


def segment_smem(K: int, m: int, backward: bool, direct: int) -> int:
    """Bytes of shared memory a block of the forward or backward kernel
    takes at K and m, in the staged (``direct=0``) or direct (``direct=1``)
    layout of ``smallk_logmmexp.cu``."""
    S, slot = 1 << m, K * (K if direct else K | 1)
    stage = K * K * S + 8
    if backward:
        slots = (0 if direct else S) + (S - 2) + (S - 1)
    else:
        slots = (0 if direct else S) + (S // 2 if m >= 2 else 0)
    return 4 * (_HEAD + stage + slots * slot + S * K + _PAD)


def _fixup_floats(K, m, backward, x0, rec):
    S, slot = 1 << m, K * (K | 1)
    stage = K * K * S + 8 if x0 else 0
    if not backward:
        inner = (S // 2 if m >= 2 else 0) + (S // 4 if m >= 3 else 0)
        half = S // 2 * K * K                       # a level's -log2(sum) and t*
        return _HEAD + stage + (inner + S) * slot + S * K + half + -(-half // 4) + _PAD
    head = -(-(_HEAD + stage) // 4) * 4 + fixup_saved(K, m)
    return head + (fixup_records(K, m) if rec else 0) + _PAD


def fixup_records(K: int, m: int) -> int:
    """Floats of the backward fix-up's records of one segment: (al, be,
    -log2(sum), G) for each entry of its ``2^m - 1`` pairs."""
    return ((1 << m) - 1) * 4 * K * K


def fixup_saved(K: int, m: int) -> int:
    """Floats the forward fix-up keeps for the backward of each segment
    job (``smallk_logmmexp.cu``): the inner levels' nodes, then each
    entry's -log2(sum) and its t* (a byte) in every pair."""
    S, slot, KK = 1 << m, K * (K | 1), K * K
    return -(-((S - 2) * slot + (S - 1) * KK + -(-((S - 1) * KK) // 4)) // 4) * 4


def fixup_layout(K: int, m: int, backward: bool) -> tuple[int, int, int]:
    """``(x0, rec, bytes)`` of the forward or backward fix-up's layout
    (``smallk_logmmexp.cu``): the segment's operators (``x0``) and the
    backward's records (``rec``) in shared memory where they fit, the
    records given up first; bytes 0 where no layout fits."""
    for x0, rec in ((1, 1), (1, 0), (0, 0)):
        rec = rec if backward else 0
        nbytes = 4 * _fixup_floats(K, m, backward, x0, rec)
        if nbytes <= SMEM_PER_BLOCK:
            return x0, rec, nbytes
    return 0, 0, 0


def fixup_smem(K: int, m: int, backward: bool) -> int:
    """Bytes of shared memory a block of the forward or backward fix-up
    takes at K and m (0 where none fits)."""
    return fixup_layout(K, m, backward)[2]


def layout_for(K: int, m: int, backward: bool) -> int:
    """0, the staged layout (the next segment loads while a block reduces
    this one), where it fits in a block's shared memory, else 1, the
    direct layout."""
    return 0 if segment_smem(K, m, backward, 0) <= SMEM_PER_BLOCK else 1


def _blocks_per_sm(nbytes: int) -> int:
    return SMEM_PER_SM // (nbytes + SMEM_RESERVED)


def segment_levels(n: int, K: int) -> int:
    """m for one launch over n >= 2 operators: the largest m (at most
    ceil(log2 n) and :data:`MAX_M`) at which two blocks of the backward
    still fit on an SM, else 1."""
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K}: the small-K kernels take 1 <= K <= {MAX_K}")
    for m in range(min(MAX_M, (n - 1).bit_length()), 1, -1):
        if _blocks_per_sm(segment_smem(K, m, True, layout_for(K, m, True))) >= 2:
            return m
    return 1


def launch_plan(T: int, K: int) -> list[int]:
    """The m of each launch that reduces a chain of T operators to one."""
    plan = []
    while T > 1:
        m = segment_levels(T, K)
        plan.append(m)
        T = (T + (1 << m) - 1) >> m
    return plan


def log_mismatches(device="cuda") -> int:
    """Floats x in [FLT_MIN, 128] (every value ``c + tiny`` takes for K <=
    128) where the kernels' logarithm differs from ``logf`` on the card."""
    count = torch.zeros(1, dtype=torch.int32, device=device)
    lib = load("smallk_logmmexp", _SIGNATURES)
    with torch.cuda.device(count.device):
        rc = lib.smallk_log_mismatches(0x00800000, 0x43000000, ptr(count), stream(count))
    check_status(rc, "smallk_log_mismatches")
    return int(count.item())


def _check_segment(x, m):
    """Raise on a launch the kernels do not take; returns (nB, n, K)."""
    if x.device.type != "cuda":
        raise ValueError(f"the small-K kernels take CUDA tensors, not {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"the small-K kernels take float32, not {x.dtype}")
    if x.dim() != 4 or x.shape[2] != x.shape[3]:
        raise ValueError(f"a chain is (nB, n, K, K), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("a chain must be contiguous")
    nB, n, K, _ = x.shape
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K}: the small-K kernels take 1 <= K <= {MAX_K}")
    if not 1 <= m <= MAX_M:
        raise ValueError(f"m={m}: a launch takes 1 to {MAX_M} tree levels")
    if n < 2 or nB < 1:
        raise ValueError(f"a launch needs n >= 2 operators and a chain, got "
                         f"nB={nB}, n={n}")
    if nB * ((n + (1 << m) - 1) >> m) > _INT_MAX:
        raise ValueError(f"nB={nB}, n={n}, m={m}: more segments than a launch takes")
    if not (fixup_smem(K, m, False) and fixup_smem(K, m, True)):
        raise ValueError(f"K={K}, m={m}: the joint-shift fix-ups do not fit in shared "
                         f"memory (launch_plan picks an m that does)")
    return nB, n, K


def _sm_count(device):
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


_SMS: dict = {}


def fast_fwd(x, m):
    """The forward kernel alone: its output, where the flagged segments
    are left to the fix-up, and the flags."""
    nB, n, K = _check_segment(x, m)
    nseg = (n + (1 << m) - 1) >> m
    out = torch.empty((nB, nseg, K, K), device=x.device, dtype=torch.float32)
    flags = torch.zeros(nB * nseg, device=x.device, dtype=torch.int32)
    lib = load("smallk_logmmexp", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.smallk_segment_fwd(ptr(x), ptr(out), ptr(flags), nB, n, K, m,
                                    layout_for(K, m, False), stream(x))
    check_status(rc, "smallk_segment_fwd")
    return out, flags


def fixup_fwd(x, out, flags, m, save=False):
    """The forward fix-up alone, over :func:`fast_fwd`'s output and flags;
    with ``save``, returns what the backward fix-up takes (else None)."""
    nB, n, K, _ = x.shape
    jobs = nB * ((n + (1 << m) - 1) >> m)
    saved = (torch.empty(jobs * fixup_saved(K, m), device=x.device, dtype=torch.float32)
             if save else None)
    lib = load("smallk_logmmexp", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.smallk_fixup_fwd(ptr(x), ptr(out), ptr(flags), ptr(joint_counter(x.device)),
                                  ptr(saved), nB, n, K, m, stream(x))
    check_status(rc, "smallk_fixup_fwd")
    return saved


def _launch_fwd(x, m, save=False):
    """One launch forward on the card, the fast kernel and its fix-up:
    (nB, n, K, K) -> (nB, ceil(n/2^m), K, K), its flags and, with ``save``,
    what its backward takes."""
    global FWD_LAUNCHES
    out, flags = fast_fwd(x, m)
    saved = fixup_fwd(x, out, flags, m, save)
    FWD_LAUNCHES += 1
    return out, flags, saved


def fast_bwd(x, g, m, flags=None):
    """The backward kernel alone: dx, where the flagged segments are left
    to the fix-up, and the flags.  ``flags``: the forward launch's over the
    same x (:func:`fast_fwd`), whose segments the kernel then skips
    unread; else it finds them itself."""
    nB, n, K = _check_segment(x, m)
    shape = (nB, (n + (1 << m) - 1) >> m, K, K)
    if (g.device != x.device or g.dtype != torch.float32 or not g.is_contiguous()
            or tuple(g.shape) != shape):
        raise ValueError(f"g must be a contiguous float32 {shape} tensor on "
                         f"{x.device}, got {tuple(g.shape)}")
    dx = torch.empty_like(x)
    if flags is None:
        flags = torch.zeros(nB * shape[1], device=x.device, dtype=torch.int32)
    lib = load("smallk_logmmexp", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.smallk_segment_bwd(ptr(x), ptr(g), ptr(dx), ptr(flags), nB, n, K, m,
                                    layout_for(K, m, True), stream(x))
    check_status(rc, "smallk_segment_bwd")
    return dx, flags


def fixup_bwd(x, g, dx, flags, saved, m):
    """The backward fix-up alone, over :func:`fast_bwd`'s dx and flags and
    the forward fix-up's ``saved`` state over the same x.  Where its
    records do not fit in shared memory it takes a scratch of device memory
    for one block an SM."""
    nB, n, K, _ = x.shape
    if saved is None:
        raise ValueError("the backward fix-up takes the forward fix-up's saved state")
    _, rec, _ = fixup_layout(K, m, True)
    blocks = 0 if rec else _sm_count(x.device)
    scratch = (None if rec else
               torch.empty(blocks * fixup_records(K, m), device=x.device, dtype=torch.float32))
    lib = load("smallk_logmmexp", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.smallk_fixup_bwd(ptr(x), ptr(g), ptr(dx), ptr(flags), ptr(saved), ptr(scratch),
                                  blocks, nB, n, K, m, stream(x))
    check_status(rc, "smallk_fixup_bwd")
    return dx


def _launch_bwd(x, g, m, flags=None, saved=None):
    """One launch backward on the card: the gradient of the launch's input
    from ``g``, the gradient of its output, given the forward launch's
    flags (whose segments the fast kernel skips; the same x flags no
    others) and saved state (:func:`fixup_bwd` raises without it)."""
    global BWD_LAUNCHES
    dx, flags = fast_bwd(x, g, m, flags)
    fixup_bwd(x, g, dx, flags, saved, m)
    BWD_LAUNCHES += 1
    return dx


class _Segment(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m):
        ctx.m = m
        out, flags, saved = _launch_fwd(x, m, save=ctx.needs_input_grad[0])
        ctx.save_for_backward(x, flags, saved)
        return out

    @staticmethod
    def backward(ctx, g):
        x, flags, saved = ctx.saved_tensors
        return _launch_bwd(x, g.contiguous(), ctx.m, flags, saved), None


def reference_level(x):
    """Plain PyTorch version of one tree level (``ops.logmmexp.logmmexp`` on
    the even and odd operators, the joint-shift repair included, the odd
    remainder carried over)."""
    n = x.shape[1]
    A, B = x[:, 0:n - n % 2:2], x[:, 1:n:2]
    a_max = torch.amax(A, dim=-1, keepdim=True).detach()
    b_max = torch.amax(B, dim=-2, keepdim=True).detach()
    a_max = torch.where(torch.isfinite(a_max), a_max, torch.zeros_like(a_max))
    b_max = torch.where(torch.isfinite(b_max), b_max, torch.zeros_like(b_max))
    C = torch.matmul(torch.exp(A - a_max), torch.exp(B - b_max))
    out = joint_repair(torch.log(C + _TINY) + a_max + b_max, C, A, B)
    if n % 2:
        out = torch.cat([out, x[:, n - 1:]], dim=1)
    return out


def _reduce(x):
    while x.shape[1] != 1:
        x = reference_level(x)
    return x


def reference_segment(x, m):
    """Plain PyTorch version of one launch: each aligned segment of ``2^m``
    operators of ``x`` (nB, n, K, K), the short last one included, reduced
    to one operator by :func:`reference_level`."""
    nB, n, K, _ = x.shape
    S = 1 << m
    full = n // S
    parts = []
    if full:
        head = x[:, :full * S].reshape(nB * full, S, K, K)
        parts.append(_reduce(head).reshape(nB, full, K, K))
    if n % S:
        parts.append(_reduce(x[:, full * S:]))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def logmmexp_segment(x, m):
    """One launch of the plan over (nB, n, K, K): the kernels for a CUDA
    tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return reference_segment(x, m)
    if x.device.type != "cuda":
        raise ValueError(f"the small-K chain runs on CUDA or the CPU, not {x.device}")
    return _Segment.apply(x.contiguous(), m)


def chain_logmmexp_smallk(ms):
    """Reduce ``ms[..., T, K, K]`` over T with the balanced pairwise tree of
    ``ops.logmmexp.chain_logmmexp``, one :func:`logmmexp_segment` per entry
    of :func:`launch_plan`."""
    *batch, T, K, _ = ms.shape
    if ms.dtype != torch.float32:
        raise TypeError(f"the small-K chain takes float32, got {ms.dtype}")
    x = ms.reshape(-1, T, K, K)
    for m in launch_plan(T, K):
        x = logmmexp_segment(x, m)
    return x[:, 0].reshape(*batch, K, K)
