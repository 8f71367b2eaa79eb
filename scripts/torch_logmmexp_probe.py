#!/usr/bin/env python3
"""Probe the port's fused log-matmul kernel on one NVIDIA card.

    python3 scripts/torch_logmmexp_probe.py [--parent DIR] [--sass FILE] [--no-scale]

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
        times["plain_ms"] = [graph_ms(lambda: lk.reference_logmmexp(A, B))]
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
