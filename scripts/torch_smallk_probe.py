#!/usr/bin/env python3
"""Probe the port's small-K chain kernels on one NVIDIA card.

    python3 scripts/torch_smallk_probe.py [--parent DIR] [--diag] [--phases] [--sass FILE]

Builds ``alan_tpu_torch/csrc/smallk_logmmexp.cu`` with ``-Xptxas -v`` and
prints what ptxas reports for each kernel (registers, spills), and counts
the floats in [FLT_MIN, 128] (every value c + FLT_MIN takes) where the
kernels' logarithm differs from logf.  Then, at covid's chain (2760 chains,
T = 109, K = 30): the chain forward and backward against the plain
level-by-level version (max abs error, bitwise or not) and their times
(CUDA events, median of 7 x 3 runs) over the launch plan, each launch's
time, and the same for the direct layout and for plans of shallower
segments (every launch at m <= 1, 2).  Options:

  --parent DIR  also time, in the same process, the one-level-a-launch
                kernel of an earlier checkout (its 7 level launches);
  --diag        also time a build with expf and the logarithm replaced by
                the identity (wrong results: the time the transcendentals
                take);
  --phases      also time the phases of each job of the first launch: a
                build whose blocks add the clock64() cycles between their
                barriers to a device counter, averaged over the jobs, and
                each block's lifetime against the launch's event time;
  --sass FILE   write cuobjdump -sass of the kernels to FILE.

Clocks and power (nvidia-smi) are sampled before and after.  One JSON line
per result.
"""
import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CHAIN = (92 * 30, 109, 30)


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


def ok(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} returned CUDA error {rc}")


def build(name, src, extra):
    from alan_tpu_torch import _build
    b = _build._Build(name, [_build._nvcc()], src, _build.NVCC_FLAGS + extra)
    path = b.wait()
    return path, b.log


def phase_source(text):
    """The kernel source with phase clocks: in each job of a block, thread 0
    adds the clock64() cycles between its barriers to
    phase_cycles[kind][phase] (kind 0 forward, 1 backward; [kind][31]
    counts the jobs), read and reset through two extra C entry points."""
    import re
    hook = """
__device__ unsigned long long phase_cycles[2][32];
#define MARK(k) if (threadIdx.x == 0) { long long now_ = clock64(); \\
  atomicAdd(&phase_cycles[k][ph_ < 31 ? ph_ : 30], (unsigned long long)(now_ - t0_)); \\
  ++ph_; t0_ = now_; }
"""
    text = text.replace("namespace {\n", "namespace {\n" + hook, 1)
    for kind, name, nxt in ((0, "segment_fwd_kernel(", "// dx of each segment"),
                            (1, "segment_bwd_kernel(", "// Counts the floats x")):
        a = text.index(name)
        b = text.index(nxt, a)
        body = text[a:b]
        body = body.replace("extern __shared__ float sh[];",
                            "extern __shared__ float sh[];\n  long long t0_ = clock64(); int ph_ = 0;")
        body = body.replace("++it) {", "++it) {\n    ph_ = 0;\n    if (threadIdx.x == 0) "
                            f"atomicAdd(&phase_cycles[{kind}][31], 1ull);", 1)
        body = body.replace("long long t0_ = clock64();", "long long t0_ = clock64(), start_ = t0_;", 1)
        end = body.rindex("\n}\n")
        body = (body[:end] + f"\n  if (threadIdx.x == 0) atomicAdd(&phase_cycles[{kind}][29], "
                "(unsigned long long)(clock64() - start_));" + body[end:])
        body = re.sub(r"__syncthreads\(\);", f"__syncthreads(); MARK({kind});", body)
        text = text[:a] + body + text[b:]
    text += """
extern "C" int smallk_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));
}
extern "C" int smallk_phase_reset() {
  static unsigned long long zero[2][32];
  return (int)cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
}
"""
    return text


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="checkout of a tree with the one-level kernel")
    ap.add_argument("--diag", action="store_true",
                    help="also time a build with expf and logf replaced by the identity")
    ap.add_argument("--phases", action="store_true",
                    help="also time each phase of a job with clock64()")
    ap.add_argument("--sass", help="write cuobjdump -sass of the kernels to this file")
    args = ap.parse_args()
    import numpy as np
    import torch
    from alan_tpu_torch.ops import smallk_kernel as sk
    if not torch.cuda.is_available():
        sys.exit("no card")
    emit({"card": smi()})

    src = os.path.join(REPO, "alan_tpu_torch", "csrc", "smallk_logmmexp.cu")
    path, log = build("smallk_probe", src, ["-Xptxas", "-v"])
    emit({"ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling entry" in ln]})
    if args.sass:
        import shutil
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True).stdout
        with open(args.sass, "w") as fh:
            fh.write(sass)
        emit({"sass_lines": len(sass.splitlines())})
    P, I = ctypes.c_void_p, ctypes.c_int

    def bind(path):
        lib = ctypes.CDLL(path)
        # the fast kernels alone: a null flags pointer skips the flag store
        # of the joint-shift fix-up, which the probe does not launch
        lib.smallk_segment_fwd.argtypes = [P, P, P, I, I, I, I, I, P]
        lib.smallk_segment_bwd.argtypes = [P, P, P, P, I, I, I, I, I, P]
        lib.smallk_smem_bytes.argtypes = [I, I, I, I]
        lib.smallk_log_mismatches.argtypes = [ctypes.c_uint, ctypes.c_uint, P, P]
        return lib
    lib = bind(path)

    B, T, K = CHAIN
    rng = np.random.default_rng(20)
    ms = torch.from_numpy(rng.standard_normal((B, T, K, K), dtype=np.float32) * 2 - 1).cuda()
    W = torch.from_numpy(rng.standard_normal((B, K, K), dtype=np.float32)).cuda()
    x = ms.clone().requires_grad_(True)
    y = x
    while y.shape[1] != 1:
        y = sk.reference_level(y)
    (gwant,) = torch.autograd.grad((y[:, 0] * W).sum(), [x])
    want = y[:, 0].detach()
    del x, y
    st = lambda: P(torch.cuda.current_stream().cuda_stream)

    def run_plan(plan, lib=lib, direct=None):
        xs, cur = [], ms
        for m in plan:
            out = torch.empty((B, (cur.shape[1] + (1 << m) - 1) >> m, K, K), device="cuda")
            d = sk.layout_for(K, m, False) if direct is None else direct
            ok(lib.smallk_segment_fwd(cur.data_ptr(), out.data_ptr(), None, B, cur.shape[1],
                                      K, m, d, st()), "forward")
            xs.append(cur)
            cur = out
        return xs, cur

    def run_back(xs, plan, g, lib=lib, direct=None):
        for xin, m in reversed(list(zip(xs, plan))):
            dx = torch.empty_like(xin)
            d = sk.layout_for(K, m, True) if direct is None else direct
            ok(lib.smallk_segment_bwd(xin.data_ptr(), g.data_ptr(), dx.data_ptr(), None, B,
                                      xin.shape[1], K, m, d, st()), "backward")
            g = dx
        return g

    def check(tag, plan, lib=lib, direct=None):
        xs, out = run_plan(plan, lib, direct)
        dx = run_back(xs, plan, g_top, lib, direct)
        torch.cuda.synchronize()
        got = out[:, 0]
        res = {"case": tag, "plan": plan, "direct": direct,
               "fwd_ms": cuda_ms(lambda: run_plan(plan, lib, direct)),
               "bwd_ms": cuda_ms(lambda: run_back(xs, plan, g_top, lib, direct)),
               "fwd_err": (got - want).abs().max().item(),
               "bwd_err": (dx - gwant).abs().max().item(),
               "fwd_bitwise": bool(torch.equal(got, want)),
               "bwd_bitwise": bool(torch.equal(dx, gwant))}
        emit(res)
        return xs

    count = torch.zeros(1, dtype=torch.int32, device="cuda")
    ok(lib.smallk_log_mismatches(0x00800000, 0x43000000, count.data_ptr(), st()), "log check")
    emit({"log_mismatches_FLT_MIN_to_128": int(count.item())})
    plan = sk.launch_plan(T, K)
    emit({"plan": plan,
          "smem_fwd": [lib.smallk_smem_bytes(K, m, 0, sk.layout_for(K, m, False)) for m in plan],
          "smem_bwd": [lib.smallk_smem_bytes(K, m, 1, sk.layout_for(K, m, True)) for m in plan]})
    g_top = W.reshape(B, 1, K, K).contiguous()
    xs = check("plan", plan)
    each = []
    for i, (xi, m) in enumerate(zip(xs, plan)):
        gi = torch.randn((B, (xi.shape[1] + (1 << m) - 1) >> m, K, K), device="cuda")
        each.append({"n": xi.shape[1], "m": m,
                     "fwd_ms_through_here": cuda_ms(lambda: run_plan(plan[:i + 1])),
                     "bwd_ms": cuda_ms(lambda: run_back([xi], [m], gi))})
    emit({"per_launch": each})
    del xs
    check("direct layout", plan, direct=1)
    for m_fixed in (1, 2):
        p, n = [], T
        while n > 1:
            p.append(min(m_fixed, (n - 1).bit_length()))
            n = (n + (1 << p[-1]) - 1) >> p[-1]
        check(f"every launch m <= {m_fixed}", p)

    import shutil
    import tempfile
    tmp = tempfile.mkdtemp()
    if args.diag:
        with open(src) as fh:
            text = fh.read().replace("expf(", "(").replace("log_normal(acc", "(acc")
        dsrc = os.path.join(tmp, "smallk_diag.cu")
        with open(dsrc, "w") as fh:
            fh.write(text)
        check("no expf/logf (wrong results)", plan, bind(build("smallk_diag", dsrc, [])[0]))
    if args.phases:
        with open(src) as fh:
            text = phase_source(fh.read())
        psrc = os.path.join(tmp, "smallk_phases.cu")
        with open(psrc, "w") as fh:
            fh.write(text)
        plib = bind(build("smallk_phases", psrc, [])[0])
        plib.smallk_phase_read.argtypes = [P]
        xs, out = run_plan(plan[:1], plib)
        run_back(xs, plan[:1], torch.randn_like(out), plib)
        torch.cuda.synchronize()
        plib.smallk_phase_reset()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        gl = torch.randn_like(out)
        ev[0].record()
        xs, out = run_plan(plan[:1], plib)
        ev[1].record()
        run_back(xs, plan[:1], gl, plib)
        ev[2].record()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 64)()
        ok(plib.smallk_phase_read(buf), "phase read")
        blocks = torch.cuda.get_device_properties(0).multi_processor_count
        for kind, tag in ((0, "fwd"), (1, "bwd")):
            row = list(buf)[32 * kind: 32 * kind + 32]
            launch_ms = ev[kind].elapsed_time(ev[kind + 1])
            grid = blocks * (3 if kind == 0 else 2)     # FWD_BLOCKS, BWD_BLOCKS at covid's K
            emit({"phases": tag, "jobs": row[31], "launch_ms": launch_ms,
                  "avg_block_cycles": row[29] / grid,
                  "cycles_per_ns": row[29] / grid / (launch_ms * 1e6),
                  "avg_cycles": [round(v / row[31]) for v in row[:29] if v]})
        del xs, out
    shutil.rmtree(tmp)

    if args.parent:
        psrc = os.path.join(args.parent, "alan_tpu_torch", "csrc", "smallk_logmmexp.cu")
        ppath, _ = build("smallk_parent", psrc, [])
        plib = ctypes.CDLL(ppath)
        plib.smallk_logmmexp_fwd.argtypes = [P, P, I, I, I, P]
        plib.smallk_logmmexp_bwd.argtypes = [P, P, P, I, I, I, P]

        def plevel(xin):
            n = xin.shape[1]
            out = torch.empty((B, (n + 1) // 2, K, K), device="cuda")
            ok(plib.smallk_logmmexp_fwd(xin.data_ptr(), out.data_ptr(), B, n, K, st()), "parent")
            if n % 2:
                out[:, -1].copy_(xin[:, -1])
            return out

        pxs, cur = [], ms
        while cur.shape[1] != 1:
            pxs.append(cur)
            cur = plevel(cur)
        pgs = [torch.randn((B, (xi.shape[1] + 1) // 2, K, K), device="cuda") for xi in pxs]

        def pfwd():
            c = ms
            while c.shape[1] != 1:
                c = plevel(c)

        def pbwd():
            for xi, gi in zip(pxs, pgs):
                dxi = torch.empty_like(xi)
                ok(plib.smallk_logmmexp_bwd(xi.data_ptr(), gi.data_ptr(), dxi.data_ptr(),
                                            B, xi.shape[1], K, st()), "parent")
                if xi.shape[1] % 2:
                    dxi[:, -1].copy_(gi[:, -1])

        emit({"parent_levels": len(pxs), "parent_fwd_ms": cuda_ms(pfwd),
              "parent_bwd_ms": cuda_ms(pbwd)})
    emit({"card_after": smi()})


if __name__ == "__main__":
    main()
