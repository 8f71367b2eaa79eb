#!/usr/bin/env python3
"""Probe the port's small-K chain kernels on one NVIDIA card.

    python3 scripts/torch_smallk_probe.py [--parent DIR] [--diag] [--phases] [--sass FILE]

Builds ``alan_tpu_torch/csrc/smallk_logmmexp.cu`` with ``-Xptxas -v`` and
prints what ptxas reports for each kernel (registers, spills), and counts
the floats in [FLT_MIN, 128] (every value c + FLT_MIN takes) where the
kernels' logarithm differs from logf.  Then, at covid's chain (2760 chains,
T = 109, K = 30): the fast kernels alone (no flags, so no fix-up) against
the plain level-by-level version (max abs error, bitwise or not) and their
times (CUDA events, median of 7 x 3 runs) over the launch plan, each
launch's time, and the same for the direct layout and for plans of
shallower segments (every launch at m <= 1, 2); and on peaked operators
(covid's transitions, where most entries take the joint shift) the fast
launches and the joint-shift fix-ups timed apart, forward and backward.
Options:

  --parent DIR  also time, in the same process, an earlier checkout's
                chain (its fast kernels and fix-ups, from before the
                fix-ups kept state for the backward) on the peaked and on
                random operators, in turns with this tree's (parent, this,
                this, parent);
  --diag        also time a build with expf, ex2 and the logarithm
                replaced by the identity (wrong results: the time the
                transcendentals take), the fix-ups on peaked operators too;
  --phases      also time the phases of each job of the first launch, on
                random and on peaked operators, fast kernels and fix-ups: a
                build whose blocks add the clock64() cycles between their
                barriers to a device counter, averaged over the jobs, and
                each block's lifetime against the launch's event time;
  --sass FILE   write cuobjdump -sass of the kernels to FILE;
  --variant L|OLD|NEW
                also time, in the same process, the peaked fix-ups of a
                build of the source with the text OLD replaced by NEW
                (each must occur), labelled L; repeatable, built in
                parallel.  NEW may use \\n for a newline.

Clocks and power (nvidia-smi) are sampled before and after.  One JSON line
per result.
"""
import argparse
import ctypes
import re
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


#: kernels the --phases build clocks: (kind, where the kernel starts, where
#: its body ends, the text after which a job starts)
PHASE_KERNELS = ((0, "segment_fwd_kernel(", "// dx of each segment", "++it) {"),
                 (1, "segment_bwd_kernel(", "// ---- the joint-shift fix-up", "++it) {"),
                 (2, "segment_fixup_fwd_kernel(", "// dx of each flagged segment",
                  "if (!flags[job]) continue;"),
                 (3, "segment_fixup_bwd_kernel(", "// ---- end of the fix-up",
                  "if (!flags[job]) continue;"))


def phase_source(text):
    """The kernel source with phase clocks: in each job of a block, thread 0
    adds the clock64() cycles between its barriers (and, in the fix-ups,
    the end of a segment's load) to phase_cycles[kind][phase] (kind as
    PHASE_KERNELS; [kind][31] counts the jobs, [kind][29] the blocks'
    lifetimes), read and reset through two extra C entry points."""
    import re
    hook = """
__device__ unsigned long long phase_cycles[4][32];
#define MARK(k) if (threadIdx.x == 0) { long long now_ = clock64(); \\
  atomicAdd(&phase_cycles[k][ph_ < 28 ? ph_ : 28], (unsigned long long)(now_ - t0_)); \\
  ++ph_; t0_ = now_; }
"""
    text = text.replace("namespace {\n", "namespace {\n" + hook, 1)
    for kind, name, nxt, job in PHASE_KERNELS:
        a = text.index(name)
        b = text.index(nxt, a)
        body = text[a:b]
        body = body.replace("extern __shared__ float sh[];",
                            "extern __shared__ float sh[];\n  long long t0_ = clock64(), "
                            "start_ = t0_; int ph_ = 0;")
        body = body.replace(job, job + "\n    ph_ = 0;\n    t0_ = clock64();\n"
                            f"    if (threadIdx.x == 0) atomicAdd(&phase_cycles[{kind}][31], 1ull);",
                            1)
        end = body.rindex("\n}\n")
        body = (body[:end] + f"\n  if (threadIdx.x == 0) atomicAdd(&phase_cycles[{kind}][29], "
                "(unsigned long long)(clock64() - start_));" + body[end:])
        body = re.sub(r"__syncthreads\(\);", f"__syncthreads(); MARK({kind});", body)
        body = body.replace("wait_stage(bar, loads++);", f"wait_stage(bar, loads++); MARK({kind});")
        text = text[:a] + body + text[b:]
    text += """
extern "C" int smallk_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));
}
extern "C" int smallk_phase_reset() {
  static unsigned long long zero[4][32];
  return (int)cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
}
"""
    return text


def peaked_chain(shape, seed):
    """Covid's chain with peaked transitions (as chip_smoke.py's
    _peaked_chain): log N(x[t + 1, j]; x[t, i], 0.01) between particle
    sets of spread 1 around a random walk."""
    import math
    import numpy as np
    import torch
    B, T, K = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, T + 1, K)) + np.cumsum(rng.normal(0, 0.3, (B, T + 1, 1)), axis=1)
    x = torch.from_numpy(x.astype(np.float32)).cuda()
    d = (x[:, 1:, None, :] - x[:, :-1, :, None]) / 0.01
    return -0.5 * d * d - math.log(0.01 * math.sqrt(2 * math.pi))


def sk_launches(sk):
    """This tree's fast launches and fix-ups, apart: (fast_fwd(x, m),
    fixup_fwd(x, out, flags, m) -> the state its backward takes,
    fast_bwd(x, g, m, forward flags), fixup_bwd(x, g, dx, flags, state,
    m))."""
    return (sk.fast_fwd, lambda x, o, f, m: sk.fixup_fwd(x, o, f, m, save=True), sk.fast_bwd,
            sk.fixup_bwd)


def parent_launches(plib, st):
    """An earlier tree's, whose fix-ups keep nothing for the backward (its
    C interface has no saved-state argument): the same four calls."""
    import torch
    from alan_tpu_torch.ops import smallk_kernel as sk

    def fast_fwd(x, m):
        nB, n, K, _ = x.shape
        out = torch.empty((nB, (n + (1 << m) - 1) >> m, K, K), device="cuda")
        flags = torch.zeros(out.shape[0] * out.shape[1], device="cuda", dtype=torch.int32)
        ok(plib.smallk_segment_fwd(x.data_ptr(), out.data_ptr(), flags.data_ptr(), nB, n, K,
                                   m, sk.layout_for(K, m, False), st()), "parent forward")
        return out, flags

    def fixup_fwd(x, out, flags, m):   # this interface keeps nothing for the backward
        nB, n, K, _ = x.shape
        ok(plib.smallk_fixup_fwd(x.data_ptr(), out.data_ptr(), flags.data_ptr(), None, nB, n,
                                 K, m, st()), "parent forward fix-up")

    def fast_bwd(x, g, m, forward_flags):   # this interface finds the flags itself
        nB, n, K, _ = x.shape
        dx = torch.empty_like(x)
        flags = torch.zeros(g.shape[0] * g.shape[1], device="cuda", dtype=torch.int32)
        ok(plib.smallk_segment_bwd(x.data_ptr(), g.data_ptr(), dx.data_ptr(), flags.data_ptr(),
                                   nB, n, K, m, sk.layout_for(K, m, True), st()),
           "parent backward")
        return dx, flags

    def fixup_bwd(x, g, dx, flags, state, m):
        nB, n, K, _ = x.shape
        ok(plib.smallk_fixup_bwd(x.data_ptr(), g.data_ptr(), dx.data_ptr(), flags.data_ptr(),
                                 nB, n, K, m, st()), "parent backward fix-up")
    return fast_fwd, fixup_fwd, fast_bwd, fixup_bwd


def fixup_times(ms, launches):
    """CUDA-event ms over the launch plan of ``ms``: the fast forward
    launches alone (each with its flags' memset), the forward fix-ups
    alone, and the same backward from seeded random gradients (given the
    forward's flags where the interface takes them); the share of segment
    jobs flagged."""
    import torch
    from alan_tpu_torch.ops import smallk_kernel as sk
    fast_fwd, fixup_fwd, fast_bwd, fixup_bwd = launches
    B, T, K, _ = ms.shape
    plan = sk.launch_plan(T, K)
    xs, outs, fflags, states, x = [], [], [], [], ms
    for m in plan:
        out, flags = fast_fwd(x, m)
        states.append(fixup_fwd(x, out, flags, m))
        xs.append(x)
        outs.append(out)
        fflags.append(flags)
        x = out
    gen = torch.Generator(device="cuda").manual_seed(0)
    gs = [torch.randn(o.shape, device="cuda", generator=gen) for o in outs]
    dxs, bflags = [], []
    for x, g, f, sv, m in zip(xs, gs, fflags, states, plan):   # with the forward's flags
        dx, flags = fast_bwd(x, g, m, f)
        fixup_bwd(x, g, dx, flags, sv, m)
        dxs.append(dx)
        bflags.append(flags)
    torch.cuda.synchronize()
    jobs = sum(f.numel() for f in fflags)
    return {"plan": plan,
            "flagged_share_fwd": sum(int(f.sum()) for f in fflags) / jobs,
            "flagged_share_bwd": sum(int(f.sum()) for f in bflags) / jobs,
            "fast_fwd_ms": cuda_ms(lambda: [fast_fwd(x, m) for x, m in zip(xs, plan)]),
            "fixup_fwd_ms": cuda_ms(lambda: [fixup_fwd(x, o, f, m)
                                             for x, o, f, m in zip(xs, outs, fflags, plan)]),
            "fast_bwd_ms": cuda_ms(lambda: [fast_bwd(x, g, m, f)
                                            for x, g, f, m in zip(xs, gs, fflags, plan)]),
            "fixup_bwd_ms": cuda_ms(lambda: [fixup_bwd(x, g, d, f, sv, m)
                                             for x, g, d, f, sv, m in zip(xs, gs, dxs, bflags,
                                                                          states, plan)])}


def variant_text(text, spec):
    """``spec`` 'LABEL|OLD|NEW' (\\n a newline in OLD and NEW) applied to
    a kernel source ``text``: -> (LABEL, the text with every OLD replaced
    by NEW); OLD must occur."""
    label, old, new = spec.split("|")
    old, new = old.replace("\\n", "\n"), new.replace("\\n", "\n")
    if old not in text:
        raise SystemExit(f"variant {label}: {old!r} is not in the source")
    return label, text.replace(old, new)


def time_variants(src, variants, peaked):
    """The peaked fix-ups of each variant of the source (LABEL|OLD|NEW,
    OLD replaced by NEW), its builds started together; the unchanged
    source's timed again after each, as the comparison."""
    import tempfile
    from alan_tpu_torch import _build
    from alan_tpu_torch.ops import native
    from alan_tpu_torch.ops import smallk_kernel as sk
    with open(src) as fh:
        text = fh.read()
    tmp = tempfile.mkdtemp()
    builds = []
    for i, v in enumerate(variants):
        label, changed = variant_text(text, v)
        path = os.path.join(tmp, f"smallk_variant{i}.cu")
        with open(path, "w") as fh:
            fh.write(changed)
        builds.append((label, _build._Build(f"smallk_variant{i}", [_build._nvcc()], path,
                                            _build.NVCC_FLAGS + ["-I", os.path.dirname(src)])))
    saved = native._LIBS.get("smallk_logmmexp")
    for label, b in builds:
        vlib = ctypes.CDLL(b.wait())
        for fn, sig in sk._SIGNATURES.items():
            getattr(vlib, fn).argtypes = sig
            getattr(vlib, fn).restype = ctypes.c_int
        native._LIBS["smallk_logmmexp"] = vlib
        try:
            emit({"case": f"variant {label}", **fixup_times(peaked, sk_launches(sk))})
        finally:
            native._LIBS["smallk_logmmexp"] = saved
        emit({"case": "unchanged source", **fixup_times(peaked, sk_launches(sk))})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="checkout of a tree with the one-level kernel")
    ap.add_argument("--diag", action="store_true",
                    help="also time a build with expf and logf replaced by the identity")
    ap.add_argument("--phases", action="store_true",
                    help="also time each phase of a job with clock64()")
    ap.add_argument("--sass", help="write cuobjdump -sass of the kernels to this file")
    ap.add_argument("--variant", action="append", default=[],
                    help="LABEL|OLD|NEW: time the fix-ups of the source with OLD replaced by NEW")
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
    peaked = peaked_chain(CHAIN, 26)
    if args.diag:
        with open(src) as fh:
            text = re.sub(r"(?<!float )ex2_approx\(", "(", fh.read().replace(
                "expf(", "(").replace("log_normal(acc", "(acc"))
        dsrc = os.path.join(tmp, "smallk_diag.cu")
        with open(dsrc, "w") as fh:
            fh.write(text)
        check("no expf/logf (wrong results)", plan, bind(build("smallk_diag", dsrc, [])[0]))
        from alan_tpu_torch.ops import native
        dlib = ctypes.CDLL(build("smallk_diag", dsrc, [])[0])
        for fn, sig in sk._SIGNATURES.items():
            getattr(dlib, fn).argtypes = sig
        saved = native._LIBS.get("smallk_logmmexp")
        native._LIBS["smallk_logmmexp"] = dlib
        try:
            emit({"case": "peaked fixups, no expf/ex2/logf (wrong results)",
                  **fixup_times(peaked, sk_launches(sk))})
        finally:
            native._LIBS["smallk_logmmexp"] = saved
    if args.phases:
        from alan_tpu_torch.ops import native
        with open(src) as fh:
            text = phase_source(fh.read())
        psrc = os.path.join(tmp, "smallk_phases.cu")
        with open(psrc, "w") as fh:
            fh.write(text)
        plib = ctypes.CDLL(build("smallk_phases", psrc, [])[0])
        for fn, sig in sk._SIGNATURES.items():
            getattr(plib, fn).argtypes = sig
        plib.smallk_phase_read.argtypes = [P]
        own_lib = native._LIBS.get("smallk_logmmexp")
        native._LIBS["smallk_logmmexp"] = plib   # the module's launches go to this build
        blocks = torch.cuda.get_device_properties(0).multi_processor_count
        per_sm = (3, 2, 2, 1)   # blocks an SM at covid's K: fast fwd, fast bwd, fix-ups
        try:
            for tag, x in (("random", ms), ("peaked", peaked)):
                m = plan[0]
                out, flags = sk.fast_fwd(x, m)
                g1 = torch.randn_like(out)
                sk.fast_bwd(x, g1, m)
                torch.cuda.synchronize()
                plib.smallk_phase_reset()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
                ev[0].record()
                out, flags = sk.fast_fwd(x, m)
                ev[1].record()
                saved = sk.fixup_fwd(x, out, flags, m, save=True)
                ev[2].record()
                dx, bflags = sk.fast_bwd(x, g1, m, flags)
                ev[3].record()
                sk.fixup_bwd(x, g1, dx, bflags, saved, m)
                ev[4].record()
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * 128)()
                ok(plib.smallk_phase_read(buf), "phase read")
                for kind, name in enumerate(("fast_fwd", "fast_bwd", "fixup_fwd", "fixup_bwd")):
                    row = list(buf)[32 * kind: 32 * kind + 32]
                    at = (0, 2, 1, 3)[kind]
                    launch_ms = ev[at].elapsed_time(ev[at + 1])
                    grid = min(blocks * per_sm[kind], flags.numel())
                    emit({"phases": name, "operands": tag, "jobs": row[31],
                          "launch_ms": launch_ms, "avg_block_cycles": row[29] / grid,
                          "cycles_per_ns": row[29] / grid / (launch_ms * 1e6),
                          "avg_cycles": [round(v / max(row[31], 1)) for v in row[:29] if v]})
        finally:
            native._LIBS["smallk_logmmexp"] = own_lib
    shutil.rmtree(tmp)

    emit({"case": "peaked fixups", **fixup_times(peaked, sk_launches(sk))})
    if args.variant:
        time_variants(src, args.variant, peaked)
    if args.parent:
        psrc = os.path.join(args.parent, "alan_tpu_torch", "csrc", "smallk_logmmexp.cu")
        ppath, plog = build("smallk_parent", psrc, ["-Xptxas", "-v"])
        emit({"parent_ptxas": [ln.strip() for ln in plog.splitlines()
                               if "registers" in ln or "spill" in ln or "Compiling entry" in ln]})
        plib = ctypes.CDLL(ppath)
        plib.smallk_segment_fwd.argtypes = [P, P, P, I, I, I, I, I, P]
        plib.smallk_segment_bwd.argtypes = [P, P, P, P, I, I, I, I, I, P]
        plib.smallk_fixup_fwd.argtypes = [P, P, P, P, I, I, I, I, P]
        plib.smallk_fixup_bwd.argtypes = [P, P, P, P, I, I, I, I, P]
        for tag, x in (("peaked", peaked), ("random", ms)):   # parent, this, this, parent
            for who in ("parent", "this tree", "this tree", "parent"):
                launches = parent_launches(plib, st) if who == "parent" else sk_launches(sk)
                emit({"case": f"{who} {tag} fixups", **fixup_times(x, launches)})
    emit({"card_after": smi()})


if __name__ == "__main__":
    main()
