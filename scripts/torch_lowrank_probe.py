#!/usr/bin/env python3
"""Probe the port's lazy low-rank kernels on one NVIDIA card.

    python3 scripts/torch_lowrank_probe.py [--parent DIR] [--phases] [--sass FILE]

Builds ``alan_tpu_torch/csrc/lowrank_lse.cu`` with ``-Xptxas -v`` and prints
what ptxas reports for each kernel (registers, spills, shared memory).  Then,
at grouped MovieLens's main-path shape (S, P, I, J, F) = (1, 300, 1000,
1000, 36), operands from numpy seed 0 as in ``chip_smoke.py``: the forward
and the dD backward against the plain version (max abs error, within
rtol/atol 1e-5 resp. rtol 1e-4 / atol 1e-5 or not) and the times (CUDA
events, median of 7 x 3 launches) of the forward, the dD backward and the
backward with all three gradients, each beside its bounds (bytes at 3.35
TB/s; f32 FMAs at 67 TFLOP/s; 3xTF32 at 495 TFLOP/s and the exponentials
at 16 per SM per clock).  Options:

  --parent DIR  also time, in the same process, the kernels of an earlier
                checkout (``git archive <commit> | tar -x -C DIR``), bound
                with its own C interface; the calls alternate parent, this,
                this, parent;
  --phases      also build a copy whose tensor-core kernels add the
                clock64() cycles of each phase of a tile (the wait for the
                TMA ring, issuing the next tile's copies, the products, the
                epilogue) to a device counter from warp 0 of each block,
                and print the cycles per tile of the forward and the dD
                backward;
  --sass FILE   write cuobjdump -sass of the kernels to FILE, and count the
                tensor-core instructions (HGMMA, HMMA) in each.

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

MAIN = (1, 300, 1000, 1000, 36)
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
    """nvcc of src (a copy of it included: the kernels' headers are found
    by -I)."""
    from alan_tpu_torch import _build
    csrc = os.path.join(REPO, "alan_tpu_torch", "csrc")
    b = _build._Build(name, [_build._nvcc()], src, _build.NVCC_FLAGS + ["-I", csrc] + extra,
                      _build.HEADERS)
    return b.wait(), b.log


def bind(path):
    """The library at path; one built before the tensor-core kernels (no
    lowrank_lse_split_floats) is bound with its own signatures."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib = ctypes.CDLL(path)
    lib.split = hasattr(lib, "lowrank_lse_split_floats")
    if lib.split:
        lib.lowrank_lse_split_floats.argtypes = [I] * 5
        lib.lowrank_lse_split_floats.restype = ctypes.c_longlong
        lib.lowrank_lse_fwd.argtypes = [P] * 6 + [I] * 5 + [P]
        lib.lowrank_lse_bwd.argtypes = [P] * 11 + [I] * 5 + [P]
    else:
        lib.lowrank_lse_fwd.argtypes = [P, P, P, P, I, I, I, I, I, P]
        lib.lowrank_lse_bwd.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P]
    return lib


def launch_fwd(lib, U, V, D, out, rnd, stream):
    """lowrank_lse_fwd through either interface (the older one writes no
    rnd); returns its status."""
    import torch
    S, P, I, F = U.shape
    J = V.shape[1]
    args = [U.data_ptr(), V.data_ptr(), D.data_ptr(), out.data_ptr()]
    if lib.split:
        split = torch.empty((lib.lowrank_lse_split_floats(S, P, I, J, F),), device=U.device)
        args += [rnd.data_ptr(), split.data_ptr()]
    return lib.lowrank_lse_fwd(*args, S, P, I, J, F, stream)


def old_dv_chunks(S, P, I, J):
    """The (p, i) ranges of dV in the CUDA-core kernels before the tensor
    cores (their C interface takes the count)."""
    fill = -(-4 * 132 // (-(-J // 128) * S))
    return int(max(1, min(max(fill, -(-(P * I) // 1024)), -(-(P * I) // 32))))


def launch_bwd(lib, U, V, D, out, rnd, G, dU, dD, dV, stream):
    """lowrank_lse_bwd through either interface (dV's scratch included; the
    older one takes no rnd); returns its status."""
    import torch
    S, P, I, F = U.shape
    J = V.shape[1]
    p = lambda t: t.data_ptr() if t is not None else None
    n_chunks = P if lib.split else old_dv_chunks(S, P, I, J)
    scratch = torch.empty((n_chunks, S, J, F), device=U.device) if dV is not None else None
    args = [p(U), p(V), p(D), p(out)] + ([p(rnd)] if lib.split else []) + [
        p(G), p(dU), p(dD), p(dV), p(scratch)]
    if lib.split:
        split = torch.empty((lib.lowrank_lse_split_floats(S, P, I, J, F),), device=U.device)
        args.append(p(split))
    else:
        args.append(n_chunks if dV is not None else 0)
    return lib.lowrank_lse_bwd(*args, S, P, I, J, F, stream)


def phase_names(text):
    """The names of the source's "// phase:" marks, in order."""
    return re.findall(r"// phase: (\w+)\n", text)


def phase_source(text):
    """The source with clock64() marks at its "// phase:" comments: warp 0's
    thread 0 adds the cycles since the previous mark to
    lowrank_phase_cycles[resident i][previous mark] (slot 0 from the kernel's
    start); the last slot counts the tiles (the marks named "wait")."""
    hook = """
__device__ unsigned long long lowrank_phase_cycles[2][16];
#define PHASE_MARK(k, tile) { const long long now_ = clock64(); if (threadIdx.x == 0) { \\
  atomicAdd(&lowrank_phase_cycles[RES_I][ph_], (unsigned long long)(now_ - t0_)); \\
  if (tile) atomicAdd(&lowrank_phase_cycles[RES_I][15], 1ull); } ph_ = (k); t0_ = now_; }
"""
    text = text.replace("namespace {\n", "namespace {\n" + hook, 1)
    anchor = "  // The \"// phase:\" comments mark"
    if text.count(anchor) != 1:
        raise RuntimeError("no anchor for the phase clocks")
    text = text.replace(anchor, "  long long t0_ = clock64(); int ph_ = 0;\n" + anchor, 1)
    for k, name in enumerate(phase_names(text), start=1):
        text = text.replace(f"// phase: {name}\n",
                            f"PHASE_MARK({k}, {int(name == 'wait')});\n", 1)
    text += """
extern "C" int lowrank_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, lowrank_phase_cycles, sizeof(lowrank_phase_cycles));
}
extern "C" int lowrank_phase_reset() {
  static unsigned long long zero[2][16];
  return (int)cudaMemcpyToSymbol(lowrank_phase_cycles, zero, sizeof(zero));
}
"""
    return text


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="checkout of an earlier tree to time in the same process")
    ap.add_argument("--phases", action="store_true", help="cycles of each phase of a tile")
    ap.add_argument("--sass", help="write cuobjdump -sass of the kernels to this file")
    args = ap.parse_args()
    import numpy as np
    import torch
    from alan_tpu_torch.ops import lowrank_kernel as lk
    if not torch.cuda.is_available():
        sys.exit("torch_lowrank_probe: no CUDA card")
    emit({"card": smi(), "torch": torch.__version__, "cuda": torch.version.cuda})

    src = os.path.join(REPO, "alan_tpu_torch", "csrc", "lowrank_lse.cu")
    path, log = build("lowrank_probe", src, ["-Xptxas", "-v"])
    emit({"ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling entry" in ln
                    or "smem" in ln]})
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
            elif name and ("HMMA" in ln or "HGMMA" in ln):
                counts[name] = counts.get(name, 0) + 1
        emit({"sass_lines": len(sass.splitlines()), "tensor_core_instructions": counts})
    lib = bind(path)

    S, P, I, J, F = MAIN
    rng = np.random.default_rng(0)
    U = torch.from_numpy(rng.standard_normal((S, P, I, F), dtype=np.float32) * 0.5).cuda()
    V = torch.from_numpy(rng.standard_normal((S, J, F), dtype=np.float32) * 0.5).cuda()
    D = torch.from_numpy(rng.standard_normal((S, P, I), dtype=np.float32) * 2.0).cuda()
    G = torch.from_numpy(rng.standard_normal((S, P, J), dtype=np.float32)).cuda()
    st = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    kw = dict(device="cuda", dtype=torch.float32)

    def ok(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} returned CUDA error {rc}")

    rnd = torch.zeros((S, P, J), **kw)

    def fwd(lib):
        out = torch.empty((S, P, J), **kw)
        ok(launch_fwd(lib, U, V, D, out, rnd, st()), "forward")
        return out

    out = fwd(lib)

    def bwd(lib, all_grads=False):
        dD = torch.empty((S, P, I), **kw)
        dU = torch.empty((S, P, I, F), **kw) if all_grads else None
        dV = torch.empty((S, J, F), **kw) if all_grads else None
        ok(launch_bwd(lib, U, V, D, out, rnd, G, dU, dD, dV, st()), "backward")
        return dD

    Dg = D.clone().requires_grad_(True)
    want = lk.reference_lowrank_logsumexp(U, V, Dg)
    (dD_want,) = torch.autograd.grad(want, [Dg], G)
    got, dD_got = fwd(lib), bwd(lib)
    torch.cuda.synchronize()
    emit({"check": "main shape", "fwd_max_abs_err": (got - want).abs().max().item(),
          "fwd_within_1e-5": bool(torch.allclose(got, want.detach(), rtol=1e-5, atol=1e-5)),
          "dD_max_abs_err": (dD_got - dD_want).abs().max().item(),
          "dD_within_1e-4": bool(torch.allclose(dD_got, dD_want, rtol=1e-4, atol=1e-5))})
    del want, Dg, dD_want

    flops = 2.0 * S * P * I * J * F
    exps = S * P * I * J
    f32 = 4
    nbytes = f32 * (S * P * I * F + S * J * F + S * P * I + S * P * J)
    b_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    b_f32 = flops / PEAK_F32_FLOP_PER_S * 1e3
    b_tc = max(b_bytes, 3 * flops / PEAK_TF32_FLOP_PER_S * 1e3, exps / PEAK_EXP_PER_S * 1e3)
    res = {"shape": list(MAIN), "bound_bytes_ms": b_bytes, "bound_f32_ms": b_f32,
           "bound_3xtf32_ms": 3 * flops / PEAK_TF32_FLOP_PER_S * 1e3,
           "bound_exp_ms": exps / PEAK_EXP_PER_S * 1e3, "bound_tc_ms": b_tc}
    if args.parent:
        psrc = os.path.join(args.parent, "alan_tpu_torch", "csrc", "lowrank_lse.cu")
        plib = bind(build("lowrank_parent", psrc, [])[0])
        seq = [("parent", plib), ("this", lib), ("this", lib), ("parent", plib)]
    else:
        seq = [("this", lib)]
    times = {}
    for tag, l in seq:
        for what, fn in (("fwd", lambda: fwd(l)), ("bwd_dD", lambda: bwd(l)),
                         ("bwd_all", lambda: bwd(l, True))):
            times.setdefault(f"{tag}_{what}_ms", []).append(cuda_ms(fn))
    for k, v in times.items():
        res[k] = v if len(v) > 1 else v[0]
    for what in ("fwd", "bwd_dD"):
        t = statistics.median(times[f"this_{what}_ms"])
        res[f"{what}_share_f32"] = b_f32 / t
        res[f"{what}_share_tc"] = b_tc / t
    emit(res)

    if args.phases:
        tmp = tempfile.mkdtemp()
        try:
            with open(src) as fh:
                text = fh.read()
            names = ["setup"] + phase_names(text)
            text = phase_source(text)
            psrc = os.path.join(tmp, "lowrank_phases.cu")
            with open(psrc, "w") as fh:
                fh.write(text)
            plib = bind(build("lowrank_phases", psrc, [])[0])
            plib.lowrank_phase_read.argtypes = [ctypes.c_void_p]
            fwd(plib), bwd(plib)
            torch.cuda.synchronize()
            plib.lowrank_phase_reset()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            fwd(plib)
            ev[1].record()
            bwd(plib)
            ev[2].record()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 32)()
            ok(plib.lowrank_phase_read(buf), "phase read")
            for kind, tag in ((0, "fwd"), (1, "bwd_dD")):
                row = list(buf)[16 * kind: 16 * kind + 16]
                tiles = row[15]
                emit({"phases": tag, "tiles": tiles, "launch_ms": ev[kind].elapsed_time(ev[kind + 1]),
                      "cycles_per_tile": {name: row[i] / tiles for i, name in enumerate(names)
                                          if name != "done"}})
        finally:
            shutil.rmtree(tmp)
    emit({"card_after": smi()})


if __name__ == "__main__":
    main()
