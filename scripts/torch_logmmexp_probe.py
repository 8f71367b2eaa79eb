#!/usr/bin/env python3
"""Probe the port's fused log-matmul kernel on one NVIDIA card.

    python3 scripts/torch_logmmexp_probe.py [--parent DIR] [--ar1]
        [--fixups [--variant 'LABEL|OLD|NEW' ...] [--phases]] [--sass FILE] [--no-scale]

Builds ``alan_tpu_torch/csrc/logmmexp.cu`` with ``-Xptxas -v`` and prints
what ptxas reports for each kernel (registers, spills, shared memory, and
any note on the wgmma pipeline).  Then, at both levels of the AR(1) chain at
K = 1000, (nb, M, K, N) = (2, 1000, 1000, 1000) and (1, 1000, 1000, 1000),
operands from numpy seeds as in ``chip_smoke.py``: the kernel against its
plain version (max abs error, within rtol/atol 1e-5 or not) and the device
times (CUDA graphs of 20 calls, median of 5 replays; the whole also eager:
back-to-back calls, the host's share included, median of 7 x 3) of the
pre-pass, the product and the whole at each tile width the product kernel is
built for (64 and 128; the host's choice marked), beside the bounds (bytes
at 3.35 TB/s; f32 FMAs at 67 TFLOP/s; 3xTF32 at 495 TFLOP/s).  Options:

  --parent DIR  also time, in the same process, the fused kernel of an
                earlier checkout (``git archive <commit> | tar -x -C DIR``),
                bound with its own C interface (one ``logmmexp_fwd``, as
                the CUDA-core kernel had, or the pre-pass and product of
                this one); the calls alternate parent, this, this, parent;
  --ar1         time the AR(1) model's ELBO at K = 1000 on the host clock and
                its device busy time (torch.profiler) per ELBO, with this
                tree's package and, with --parent, the parent's (each in a
                process of its own, alternating parent, this, this, parent);
  --fixups      time the joint-shift fix-ups on AR(1)'s own operators at
                K = 1000 (the ELBO's two products and the gradients that
                ``marginals()`` hands back) and, forward, on random operands
                of the first level (nothing flagged): the forward fix-up without and
                with the state kept for the backward, and the backward
                fix-up, each beside its bound (K exponentials a joint entry
                at 4.18e12 a second); with --parent, the parent tree's
                fix-up kernels on the same operands, flags and gradients, in
                turns (parent, this, this, parent), and the largest
                difference of their backward's results;
  --variant L|OLD|NEW
                with --fixups: also build a copy of logmmexp.cu with the
                text OLD replaced by NEW (each must occur; \\n a newline),
                labelled L, and time its fix-ups on the same operands, in
                turns with this tree's; repeatable (as
                ``torch_smallk_probe.py --variant``);
  --phases      with --fixups: also build a copy of logmmexp.cu whose forward
                fix-up clocks (clock64, thread 0 of each block) its phases:
                the flags and the list, the walk, the epilogue, and within
                the walk the cycles spent in its arithmetic (the rest is
                waiting for stages and for the block's other warps);
                averages a block that lists an entry, on AR(1)'s operands;
  --sass FILE   write cuobjdump -sass of the kernels to FILE, and count the
                tensor-core instructions (HGMMA, HMMA) in each;
  --no-scale    also build a copy whose exponentials carry no power of two
                (``SCALE_BITS = 0``) and print, beside this build, its error
                against the plain version and f64 on sums of products in
                [e^-80, e^-78] and below FLT_MIN: what the tensor cores do
                with products and hi.lo parts below FLT_MIN.

Clocks and power (nvidia-smi) are sampled before and after.  One JSON line
per result.
"""
import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
CSRC = os.path.join(REPO, "alan_tpu_torch", "csrc")

LEVELS = {"level": (2, 1000, 1000, 1000), "top": (1, 1000, 1000, 1000)}
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
PEAK_EXP_PER_S = 16 * 132 * 1.98e9


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps=7, inner=3):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def build(name, src, extra):
    from alan_tpu_torch import _build
    b = _build._Build(name, [_build._nvcc()], src,
                      _build.NVCC_FLAGS + ["-I", CSRC] + extra, _build.HEADERS)
    return b.wait(), b.log


class Fused:
    """The fused kernel of one library, through either C interface."""

    def __init__(self, path):
        P, I = ctypes.c_void_p, ctypes.c_int
        self.lib = lib = ctypes.CDLL(path)
        self.split = hasattr(lib, "logmmexp_prepass")
        if self.split:
            lib.logmmexp_scratch_floats.argtypes = [I] * 5
            lib.logmmexp_scratch_floats.restype = ctypes.c_longlong
            lib.logmmexp_prepass.argtypes = [P] * 5 + [I] * 5 + [P]
            lib.logmmexp_product.argtypes = [P] * 4 + [I] * 5 + [P]
        else:
            lib.logmmexp_fwd.argtypes = [P] * 5 + [I] * 4 + [P]

    def prepass(self, A, B, bn):
        import torch
        nb, M, K = A.shape
        N = B.shape[2]
        kw = dict(device=A.device, dtype=torch.float32)
        a_max, b_max = torch.empty((nb, M), **kw), torch.empty((nb, N), **kw)
        split = torch.empty((self.lib.logmmexp_scratch_floats(nb, M, K, N, bn),), **kw)
        ok(self.lib.logmmexp_prepass(A.data_ptr(), B.data_ptr(), a_max.data_ptr(),
                                     b_max.data_ptr(), split.data_ptr(), nb, M, K, N, bn,
                                     stream()), "pre-pass")
        return a_max, b_max, split

    def product(self, pre, shape, bn):
        import torch
        nb, M, K, N = shape
        a_max, b_max, split = pre
        out = torch.empty((nb, M, N), device=split.device)
        ok(self.lib.logmmexp_product(split.data_ptr(), a_max.data_ptr(), b_max.data_ptr(),
                                     out.data_ptr(), nb, M, K, N, bn, stream()), "product")
        return out

    def __call__(self, A, B, bn):
        import torch
        nb, M, K = A.shape
        N = B.shape[2]
        if self.split:
            return self.product(self.prepass(A, B, bn), (nb, M, K, N), bn)
        kw = dict(device=A.device, dtype=torch.float32)
        a_max, b_max = torch.empty((nb, M), **kw), torch.empty((nb, N), **kw)
        out = torch.empty((nb, M, N), **kw)
        ok(self.lib.logmmexp_fwd(A.data_ptr(), B.data_ptr(), a_max.data_ptr(),
                                 b_max.data_ptr(), out.data_ptr(), nb, M, K, N, stream()),
           "logmmexp_fwd")
        return out


def stream():
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ok(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} returned CUDA error {rc}")


def f64(A, B):
    import torch
    from alan_tpu_torch.ops import logmmexp_kernel as lk
    a_max, b_max = lk._shifts(A.double(), B.double())
    C = torch.exp(A.double() - a_max) @ torch.exp(B.double() - b_max)
    return torch.log(C + lk._TINY) + a_max + b_max


def small_sums(shape, seed, gap, edge, top):
    """As ``chip_smoke._small_sum_operands``."""
    import chip_smoke
    return chip_smoke._small_sum_operands(shape, seed, gap, edge, top)


def graph_ms(fn):
    """Device time of one call, from a CUDA graph of 20 (``chip_smoke``)."""
    import chip_smoke
    return chip_smoke.graph_ms(fn)


def variant_libs(specs):
    """label -> the library of each variant 'LABEL|OLD|NEW' of logmmexp.cu."""
    from torch_smallk_probe import variant_text
    with open(os.path.join(CSRC, "logmmexp.cu")) as fh:
        text = fh.read()
    libs, tmp = {}, tempfile.mkdtemp()
    try:
        for i, spec in enumerate(specs):
            name, changed = variant_text(text, spec)
            path = os.path.join(tmp, f"logmmexp_variant{i}.cu")
            with open(path, "w") as fh:
                fh.write(changed)
            lib = ctypes.CDLL(build(f"logmmexp_variant{i}", path, [])[0])
            lib.logmmexp_fixup.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            lib.logmmexp_fixup_bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            libs[name] = lib
    finally:
        shutil.rmtree(tmp)
    return libs


#: --phases: (text in logmmexp.cu, what goes before it); phase p adds the
#: cycles since the previous mark to slot p
PHASE_MARKS = (
    ("  const int F = total;", "MARK(0);"),
    ("  // a finite joint max leaves its own term, 2^0 = 1, in the sum", "MARK(1);"),
    ("  if (count) {", "MARK(2);"),
)
#: --phases: the walk's arithmetic, clocked apart from the waits around it
PHASE_WALK = ("    FIX_DISPATCH(ne, walk_chunk, sA, sA + FIX_TM * FIX_SA, c * FIX_KC, ro, co, mx, ts, al,\n"
              "                 be, sum);\n")


def phase_source(text):
    """logmmexp.cu with the forward fix-up's phase clocks (see --phases)."""
    hook = """
__device__ unsigned long long fix_phase_cycles[8];
#define MARK(p) if (threadIdx.x == 0) { long long now_ = clock64(); \\
  atomicAdd(&fix_phase_cycles[p], (unsigned long long)(now_ - t0_)); t0_ = now_; }
"""
    text = text.replace("namespace {\n", "namespace {\n" + hook, 1)
    head = "  __shared__ unsigned joints_s;\n"
    assert text.count(head) == 1
    text = text.replace(head, head + "  long long t0_ = clock64(), walk_ = 0;\n")
    for anchor, mark in PHASE_MARKS:
        assert text.count(anchor) == 1, anchor
        text = text.replace(anchor, mark + "\n" + anchor)
    assert text.count(PHASE_WALK) == 1
    text = text.replace(PHASE_WALK, "    { long long w_ = clock64();\n" + PHASE_WALK +
                        "      walk_ += clock64() - w_; }\n")
    text = text.replace("MARK(2);", "MARK(2); if (threadIdx.x == 0) { "
                        "atomicAdd(&fix_phase_cycles[5], (unsigned long long)walk_); "
                        "atomicAdd(&fix_phase_cycles[6], 1ull); }")
    text += """
extern "C" int fix_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, fix_phase_cycles, sizeof(fix_phase_cycles));
}
extern "C" int fix_phase_reset() {
  static unsigned long long zero[8];
  return (int)cudaMemcpyToSymbol(fix_phase_cycles, zero, sizeof(zero));
}
"""
    return text


def phase_lib():
    src = os.path.join(CSRC, "logmmexp.cu")
    with open(src) as fh:
        text = phase_source(fh.read())
    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "logmmexp_phases.cu")
        with open(path, "w") as fh:
            fh.write(text)
        lib = ctypes.CDLL(build("logmmexp_phases", path, [])[0])
    finally:
        shutil.rmtree(tmp)
    lib.logmmexp_fixup.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.fix_phase_read.argtypes = [ctypes.c_void_p]
    return lib


def own_operators():
    """AR(1)'s fused operands at K = 1000: the ELBO's (A, B) pairs and the
    (A, B, g) that ``marginals()``'s backward takes."""
    import torch
    from alan_tpu_torch.models import ar1
    from alan_tpu_torch.ops import logmmexp_kernel as lk
    problem = ar1.generate_problem("cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    fwd, bwd, orig = [], [], (lk._launch, lk._launch_bwd)

    def spy_fwd(A, B, save=False):
        fwd.append((A.clone(), B.clone()))
        return orig[0](A, B, save)

    def spy_bwd(A, B, flags, kept, g):
        bwd.append((A.clone(), B.clone(), g.clone()))
        return orig[1](A, B, flags, kept, g)
    lk._launch, lk._launch_bwd = spy_fwd, spy_bwd
    try:
        s = problem.sample(1000, gen, reparam=False)
        s.elbo_nograd()
        n = len(fwd)
        s.marginals()
    finally:
        lk._launch, lk._launch_bwd = orig
    return fwd[:n], bwd


def fixups(parent_dir, variants=(), phases=False):
    """The ``--fixups`` report (see the module's docstring)."""
    import numpy as np
    import torch
    from alan_tpu_torch.ops import logmmexp_kernel as lk
    P, I = ctypes.c_void_p, ctypes.c_int
    parent = None
    if parent_dir:
        psrc = os.path.join(parent_dir, "alan_tpu_torch", "csrc", "logmmexp.cu")
        parent = ctypes.CDLL(build("logmmexp_parent_fixups", psrc, [])[0])
        parent.logmmexp_fixup.argtypes = [P] * 7 + [I] * 4 + [P]
        parent.logmmexp_fixup_bwd.argtypes = [P] * 6 + [I] * 4 + [P]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    libs = variant_libs(variants)
    fwd, bwd = own_operators()
    # random operands of AR(1)'s first level (chip_smoke's seed): nothing flagged
    rng = np.random.default_rng(30)
    fwd.append(tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 3).cuda()
                     for shape in ((2, 1000, 1000), (2, 1000, 1000))))

    def turns(fns):
        times = {}
        order = ([("parent", fns["parent"])] if parent else []) + [
            (k, f) for k, f in fns.items() if k != "parent"]
        for who, f in order + order[::-1]:
            times.setdefault(f"{who}_ms", []).append(graph_ms(f))
        return times

    for A, B in fwd:
        nb, M, K = A.shape
        N = B.shape[2]
        bn = lk.tile_n(nb, M, N, sms)
        a_max, b_max, split = lk._prepass(A, B, bn)
        out0 = lk._product(a_max, b_max, split, nb, M, K, N, bn)
        out, flags = out0.clone(), torch.empty((nb, M, N), device="cuda", dtype=torch.bool)
        count = torch.zeros((), dtype=torch.int64, device="cuda")
        lk.JOINT_COUNT = count
        lk._fixup(A, B, a_max, b_max, out)
        lk.JOINT_COUNT = None
        joints = int(count)
        fns = {"copy": lambda: out.copy_(out0),
               "this": lambda: (out.copy_(out0), lk._fixup(A, B, a_max, b_max, out)),
               "this_saving": lambda: (out.copy_(out0),
                                       lk._fixup(A, B, a_max, b_max, out, True))}
        for name, lib in libs.items():
            fns[name] = lambda lib=lib: (out.copy_(out0), ok(lib.logmmexp_fixup(
                A.data_ptr(), B.data_ptr(), a_max.data_ptr(), b_max.data_ptr(), out.data_ptr(),
                flags.data_ptr(), None, None, None, None, None, nb, M, K, N, stream()),
                "variant fix-up"))
        if parent:
            fns["parent"] = lambda: (out.copy_(out0), ok(parent.logmmexp_fixup(
                A.data_ptr(), B.data_ptr(), a_max.data_ptr(), b_max.data_ptr(), out.data_ptr(),
                flags.data_ptr(), None, nb, M, K, N, stream()), "parent fix-up"))
        res = {"fixup": "forward", "shape": [nb, M, K, N], "joint_entries": joints,
               "entries": nb * M * N, "bound_ms": joints * K / PEAK_EXP_PER_S * 1e3,
               **turns(fns), "note": "each time includes copying out back (copy_ms)"}
        emit(res)
        if phases:
            plib = phase_lib()
            out.copy_(out0)
            plib.fix_phase_reset()
            ok(plib.logmmexp_fixup(A.data_ptr(), B.data_ptr(), a_max.data_ptr(),
                                   b_max.data_ptr(), out.data_ptr(), flags.data_ptr(), None,
                                   None, None, None, None, nb, M, K, N, stream()), "phases")
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 8)()
            ok(plib.fix_phase_read(buf), "phase read")
            n = max(buf[6], 1)
            emit({"phases": "forward fix-up", "shape": [nb, M, K, N], "blocks_walking": buf[6],
                  "avg_cycles": dict(zip(("flags_list", "walk", "epilogue"),
                                         (round(buf[p] / n) for p in range(3)))),
                  "avg_walk_arithmetic_cycles": round(buf[5] / n)})
    for A, B, g in bwd:
        nb, M, K = A.shape
        N = B.shape[2]
        count = torch.zeros((), dtype=torch.int64, device="cuda")
        lk.JOINT_COUNT = count
        _, flags, kept = lk._launch(A, B, save=True)
        lk.JOINT_COUNT = None
        joints = int(count)
        dA, dB = torch.zeros_like(A), torch.zeros_like(B)
        fns = {"this": lambda: lk._fixup_bwd(A, B, g, kept, dA, dB)}
        rec, recT, rows, cols = kept
        gT = g.transpose(1, 2).contiguous()
        for name, lib in libs.items():
            fns[name] = lambda lib=lib: ok(lib.logmmexp_fixup_bwd(
                A.data_ptr(), B.data_ptr(), g.data_ptr(), gT.data_ptr(), rec.data_ptr(),
                recT.data_ptr(), rows.data_ptr(), cols.data_ptr(), dA.data_ptr(), dB.data_ptr(),
                nb, M, K, N, stream()), "variant backward fix-up")
        if parent:
            fns["parent"] = lambda: ok(parent.logmmexp_fixup_bwd(
                A.data_ptr(), B.data_ptr(), g.data_ptr(), flags.data_ptr(), dA.data_ptr(),
                dB.data_ptr(), nb, M, K, N, stream()), "parent backward fix-up")
        res = {"fixup": "backward", "shape": [nb, M, K, N], "joint_entries": joints,
               "bound_ms": joints * K / PEAK_EXP_PER_S * 1e3, **turns(fns)}
        if parent:
            got = []
            for who in ("this", "parent"):
                dA.zero_()
                dB.zero_()
                fns[who]()
                got.append((dA.clone(), dB.clone()))
            torch.cuda.synchronize()
            res["max_abs_diff_vs_parent"] = [(x - y).abs().max().item()
                                             for x, y in zip(*got)]
            res["max_abs"] = [x.abs().max().item() for x in got[0]]
        emit(res)


AR1_CODE = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from alan_tpu_torch.models import ar1
problem = ar1.generate_problem("cuda")
gen = torch.Generator(device="cuda").manual_seed(3)
elbo = lambda: float(problem.sample(1000, gen, reparam=False).elbo_nograd())
for _ in range(3):
    elbo()
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(20):
    elbo()
ms = (time.perf_counter() - t0) / 20 * 1e3
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(5):
        elbo()
    torch.cuda.synchronize()
spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))
busy, end = 0.0, float("-inf")
for a, b in spans:
    if b > end:
        busy += b - max(a, end)
        end = b
print(json.dumps({"ms_per_elbo": ms, "device_busy_ms_per_elbo": busy / 1e3 / 5}))
"""


def ar1(tree):
    """Host ms and device busy ms per AR(1) ELBO at K = 1000, with the
    ``alan_tpu_torch`` of ``tree``, in a process of its own."""
    out = subprocess.run([sys.executable, "-c", AR1_CODE, tree], capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"AR(1) run of {tree} failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="checkout of an earlier tree to time in the same process")
    ap.add_argument("--ar1", action="store_true", help="AR(1) ms and device busy per ELBO")
    ap.add_argument("--fixups", action="store_true",
                    help="time the fix-ups on AR(1)'s own operators")
    ap.add_argument("--phases", action="store_true",
                    help="with --fixups, clock the forward fix-up's phases")
    ap.add_argument("--variant", action="append", default=[],
                    help="LABEL|OLD|NEW: with --fixups, time the fix-ups of logmmexp.cu "
                         "with OLD replaced by NEW")
    ap.add_argument("--sass", help="write cuobjdump -sass of the kernels to this file")
    ap.add_argument("--no-scale", action="store_true",
                    help="also run a build whose exponentials carry no power of two")
    args = ap.parse_args()
    import numpy as np
    import torch
    from alan_tpu_torch.ops import logmmexp_kernel as lk
    if not torch.cuda.is_available():
        sys.exit("torch_logmmexp_probe: no CUDA card")
    emit({"card": smi(), "torch": torch.__version__, "cuda": torch.version.cuda})

    src = os.path.join(CSRC, "logmmexp.cu")
    path, log = build("logmmexp_probe", src, ["-Xptxas", "-v"])
    emit({"ptxas": [ln.strip() for ln in log.splitlines()
                    if any(w in ln for w in ("registers", "spill", "Compiling entry", "smem",
                                             "wgmma", "setmaxnreg", "arning"))]})
    if args.sass:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True).stdout
        with open(args.sass, "w") as fh:
            fh.write(sass)
        counts, name = {}, None
        for ln in sass.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                name = m.group(1)
                counts.setdefault(name, 0)
            elif name and ("HMMA" in ln or "HGMMA" in ln):
                counts[name] += 1
        emit({"sass_lines": len(sass.splitlines()), "tensor_core_instructions": counts})
    this = Fused(path)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    ops = {}
    for tag, shape in LEVELS.items():
        nb, M, K, N = shape
        rng = np.random.default_rng(30 if tag == "level" else 37)
        A = torch.from_numpy(rng.standard_normal((nb, M, K), dtype=np.float32) * 3).cuda()
        B = torch.from_numpy(rng.standard_normal((nb, K, N), dtype=np.float32) * 3).cuda()
        ops[tag] = (A, B)
        want, exact = lk.reference_logmmexp(A, B), f64(A, B)
        for bn in lk.TILE_WIDTHS:
            got = this(A, B, bn)
            torch.cuda.synchronize()
            emit({"check": tag, "shape": list(shape), "tile_n": bn,
                  "max_abs_err": (got - want).abs().max().item(),
                  "err_vs_f64": (got.double() - exact).abs().max().item(),
                  "plain_err_vs_f64": (want.double() - exact).abs().max().item(),
                  "within_1e-5": bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))})

    if args.parent:
        psrc = os.path.join(args.parent, "alan_tpu_torch", "csrc", "logmmexp.cu")
        parent = Fused(build("logmmexp_parent", psrc, [])[0])
        seq = [("parent", parent), ("this", this), ("this", this), ("parent", parent)]
    else:
        seq = [("this", this)]
    for tag, shape in LEVELS.items():
        nb, M, K, N = shape
        A, B = ops[tag]
        chosen = lk.tile_n(nb, M, N, sms)
        io_bytes = 4 * nb * (M * K + K * N + M * N)
        flops = 2.0 * nb * M * K * N
        res = {"shape": list(shape), "tile_n_chosen": chosen,
               "bound_bytes_ms": io_bytes / PEAK_BYTES_PER_S * 1e3,
               "bound_f32_ms": flops / PEAK_F32_FLOP_PER_S * 1e3,
               "bound_3xtf32_ms": 3 * flops / PEAK_TF32_FLOP_PER_S * 1e3}
        times = {}
        for who, f in seq:
            widths = lk.TILE_WIDTHS if f.split else (None,)
            for bn in widths:
                key = f"{who}_ms" if bn is None else f"{who}_n{bn}"
                times.setdefault(key, []).append(graph_ms(lambda: f(A, B, bn)))
                times.setdefault(f"{key}_eager", []).append(cuda_ms(lambda: f(A, B, bn)))
                if f.split:
                    pre = f.prepass(A, B, bn)
                    times.setdefault(f"{key}_prepass", []).append(
                        graph_ms(lambda: f.prepass(A, B, bn)))
                    times.setdefault(f"{key}_product", []).append(
                        graph_ms(lambda: f.product(pre, shape, bn)))
        # the plain version finds the entries its repair takes on the host,
        # so no graph holds it: back-to-back calls, host included
        times["plain_ms"] = [cuda_ms(lambda: lk.reference_logmmexp(A, B), reps=5, inner=1)]
        for k, v in times.items():
            res[k] = v if len(v) > 1 else v[0]
        t = statistics.median(times[f"this_n{chosen}"])
        res["share_f32"] = res["bound_f32_ms"] / t
        res["share_3xtf32"] = max(res["bound_bytes_ms"], res["bound_3xtf32_ms"]) / t
        emit(res)

    if args.no_scale:
        with open(src) as fh:
            text = fh.read()
        scaled = "constexpr int SCALE_BITS = 32;"
        if text.count(scaled) != 1:
            raise RuntimeError(f"no '{scaled}' in {src}")
        tmp = tempfile.mkdtemp()
        try:
            raw_src = os.path.join(tmp, "logmmexp_noscale.cu")
            with open(raw_src, "w") as fh:
                fh.write(text.replace(scaled, "constexpr int SCALE_BITS = 0;"))
            raw = Fused(build("logmmexp_noscale", raw_src, [])[0])
        finally:
            shutil.rmtree(tmp)
        cases = {"small_sums": ((2, 300, 128, 300), 34, (39, 40), (78, 80), 37),
                 "small_sums_k1000": ((1, 300, 1000, 300), 35, (39, 40), (78, 80), 37),
                 "below_flt_min": ((2, 300, 128, 300), 36, (45, 55), (90, 110), 43)}
        for tag, spec in cases.items():
            A, B = small_sums(*spec)
            nb, M, K = A.shape
            bn = lk.tile_n(nb, M, B.shape[2], sms)
            want, exact = lk.reference_logmmexp(A, B), f64(A, B)
            res = {"case": tag, "shape": list(spec[0]),
                   "plain_err_vs_f64": (want.double() - exact).abs().max().item()}
            for who, f in (("scaled", this), ("unscaled", raw)):
                got = f(A, B, bn)
                torch.cuda.synchronize()
                res[who] = {"max_abs_err": (got - want).abs().max().item(),
                            "err_vs_f64": (got.double() - exact).abs().max().item(),
                            "within_1e-5": bool(torch.allclose(got, want, rtol=1e-5,
                                                               atol=1e-5)),
                            "first": got[0, 0, 0].item()}
            res["first_plain"], res["first_f64"] = want[0, 0, 0].item(), exact[0, 0, 0].item()
            emit(res)
    if args.fixups:
        fixups(args.parent, args.variant, args.phases)
    if args.ar1:
        trees = ([("parent", args.parent), ("this", REPO), ("this", REPO),
                  ("parent", args.parent)] if args.parent else [("this", REPO)])
        runs = {}
        for who, tree in trees:
            for k, v in ar1(tree).items():
                runs.setdefault(f"{who}_{k}", []).append(v)
        emit({"ar1": "K=1000, T=4, 20 ELBOs timed, 5 profiled", **runs})
    emit({"card_after": smi()})


if __name__ == "__main__":
    main()
