#!/usr/bin/env python3
"""Drive the PyTorch port (``alan_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # the whole check, one card

Phases, one JSON line each; any failed check makes the script exit non-zero
without its final line:

1. build     -- compile the CUDA kernels (nvcc, sm_90a) and the native
                planner (g++) from the sources in this checkout, together;
2. kernels   -- each kernel against its plain PyTorch version on the card, at
                the main-path shape (1, 300, 1000, 1000, 36), an overhang
                shape, -inf-bias cases, a feature axis wider than one chunk
                and a plate longer than a grid axis: forward rtol/atol
                1e-5, gradients rtol 1e-4 / atol 1e-5.  A gradient that
                misses that bound
                passes only if it is at least as close as the plain version
                to an f64 evaluation (long f32 sums round differently, and
                the plain version is no exact reference either).  Times from
                CUDA events, median of several runs, beside the dense
                two-call yardstick (``torch.baddbmm`` + ``torch.logsumexp``,
                never called by the port);
3. main_path -- grouped MovieLens at full width (M=300, N=5, d_z=18), K=1000,
                data from a fixed numpy seed, ``train.qem`` steps on the card;
                the launch counters are zeroed just before and read just
                after, and every kernel must have run; then a
                torch.profiler breakdown of two more steps (device busy time,
                idle share, the kernels that take the most time);
4. cross_check -- one QEM update from the same state and the same injected
                particles with the lazy path on (kernels) and off (the dense
                materialised cross product): ELBO within 1e-4 relative, the
                updated Q state within rtol/atol 1e-4.

Then the ``kernels`` line, the card's name and power limit as nvidia-smi
prints them, and ``{"ok": true, "device": {...}}`` last.
"""
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32
#: FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

MAIN_SHAPE = (1, 300, 1000, 1000, 36)   # S, P, I, J, F of grouped MovieLens K=1000
K_MAIN, QEM_STEPS = 1000, 5

FAILURES = []


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(phase, msg):
    FAILURES.append(f"{phase}: {msg}")


def cuda_ms(fn, reps=7, inner=3):
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    from CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- phase 1 ------------------------------------------------------------------

def phase_build():
    from alan_tpu_torch import _build
    t0 = time.perf_counter()
    builds = _build.start_all()
    paths = [b.wait() for b in builds]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [os.path.relpath(p, REPO) for p in paths]})


# ---- phase 2 ------------------------------------------------------------------

def _operands(shape, seed, inf_bias=False):
    import numpy as np
    import torch
    S, P, I, J, F = shape
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((S, P, I, F), dtype=np.float32) * 0.5
    V = rng.standard_normal((S, J, F), dtype=np.float32) * 0.5
    D = rng.standard_normal((S, P, I), dtype=np.float32) * 2.0
    if inf_bias:
        D = np.where(rng.random((S, P, I)) < 0.3, -np.inf, 0.0).astype(np.float32)
    G = rng.standard_normal((S, P, J), dtype=np.float32)
    return [torch.from_numpy(a).cuda() for a in (U, V, D, G)]


def _value_and_grads(f, U, V, D, G):
    import torch
    ts = [t.detach().clone().requires_grad_(True) for t in (U, V, D)]
    out = f(*ts)
    grads = torch.autograd.grad(out, ts, G)
    return out.detach(), grads


def _check_case(tag, shape, seed, inf_bias=False):
    import torch
    from alan_tpu_torch.ops import lowrank_kernel as lk
    U, V, D, G = _operands(shape, seed, inf_bias)
    got, ggot = _value_and_grads(lk.lowrank_logsumexp, U, V, D, G)
    want, gwant = _value_and_grads(lk.reference_lowrank_logsumexp, U, V, D, G)
    exact, gexact = _value_and_grads(
        lk.reference_lowrank_logsumexp, *(t.double() for t in (U, V, D, G)))
    torch.cuda.synchronize()
    res = {"phase": "kernels", "case": tag, "shape": list(shape), "ok": True}
    checks = [("out", got, want, exact, 1e-5, 1e-5)]
    checks += [(f"d{n}", a, b, c, 1e-4, 1e-5)
               for n, a, b, c in zip("UVD", ggot, gwant, gexact)]
    for name, a, b, c, rtol, atol in checks:
        err = (a - b).abs().max().item()
        close = torch.allclose(a, b, rtol=rtol, atol=atol)
        err64 = (a.double() - c).abs().max().item()
        plain64 = (b.double() - c).abs().max().item()
        res[name] = {"max_abs_err": err, "within_tol": close,
                     "err_vs_f64": err64, "plain_err_vs_f64": plain64}
        if not close and not (name != "out" and err64 <= plain64):
            res["ok"] = False
            fail("kernels", f"{tag} {name}: max abs err {err} "
                            f"(vs f64 {err64}, plain vs f64 {plain64})")
    if inf_bias and not torch.isfinite(got).all():
        res["ok"] = False
        fail("kernels", f"{tag}: non-finite output")
    emit(res)
    return res, (U, V, D, G)


def phase_kernels():
    """Kernel = plain version, and the times of both at the main shape."""
    import torch
    from alan_tpu_torch.ops import lowrank_kernel as lk
    _check_case("overhang", (2, 9, 1300, 130, 4), seed=1)
    _check_case("inf_bias", (1, 4, 64, 5, 3), seed=2, inf_bias=True)
    _check_case("inf_bias_wide", (1, 8, 1000, 300, 36), seed=3, inf_bias=True)
    _check_case("wide_f", (1, 6, 300, 200, 80), seed=4)        # F in chunks
    _check_case("long_plate", (1, 70000, 3, 5, 2), seed=5)     # P > 65535
    main, (U, V, D, G) = _check_case("main_path", MAIN_SHAPE, seed=0)

    S, P, I, J, F = MAIN_SHAPE
    out = lk._launch_fwd(U, V, D)
    fwd_ms = cuda_ms(lambda: lk._launch_fwd(U, V, D))
    bwd_ms = cuda_ms(lambda: lk._launch_bwd(U, V, D, out, G, False, False))
    bwd_all_ms = cuda_ms(lambda: lk._launch_bwd(U, V, D, out, G, True, True))
    plain_fwd_ms = cuda_ms(lambda: lk.reference_lowrank_logsumexp(U, V, D), reps=5, inner=1)
    Dg = D.clone().requires_grad_(True)
    plain_out = lk.reference_lowrank_logsumexp(U, V, Dg)
    plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(plain_out, Dg, G, retain_graph=True),
                           reps=5, inner=1)
    del plain_out, Dg

    def dense_two_call():
        A = torch.baddbmm(D.reshape(S, P * I, 1), U.reshape(S, P * I, F),
                          V.transpose(1, 2))
        return torch.logsumexp(A.reshape(S, P, I, J), dim=2)
    two_call_ms = cuda_ms(dense_two_call, reps=5, inner=1)

    f32 = 4
    fwd_bytes = f32 * (S * P * I * F + S * J * F + S * P * I + S * P * J)
    bwd_bytes = f32 * (S * P * I * F + S * J * F + 2 * S * P * I + 2 * S * P * J)
    flops = 2.0 * S * P * I * J * F
    fwd_bound, fwd_by = bound(fwd_bytes, flops)
    bwd_bound, bwd_by = bound(bwd_bytes, flops)     # dD only: the scores again
    emit({"phase": "kernels", "case": "timing", "shape": list(MAIN_SHAPE),
          "fwd_ms": fwd_ms, "bwd_dD_ms": bwd_ms, "bwd_all_grads_ms": bwd_all_ms,
          "plain_fwd_ms": plain_fwd_ms, "plain_bwd_dD_ms": plain_bwd_ms,
          "dense_two_call_ms": two_call_ms,
          "fwd_bound_ms": fwd_bound, "bwd_dD_bound_ms": bwd_bound,
          "bwd_all_grads_bound_ms": bound(bwd_bytes + f32 * (S * P * I * F + S * J * F),
                                          3 * flops)[0],
          "exp_per_call": S * P * I * J})
    return {
        "fwd": dict(max_abs_err=main["out"]["max_abs_err"], ms=fwd_ms,
                    plain_ms=plain_fwd_ms, bound_ms=fwd_bound, bound_by=fwd_by,
                    dense_two_call_ms=two_call_ms),
        "bwd": dict(max_abs_err=max(main[k]["max_abs_err"] for k in ("dU", "dV", "dD")),
                    ms=bwd_ms, plain_ms=plain_bwd_ms, bound_ms=bwd_bound,
                    bound_by=bwd_by, dense_two_call_ms=None),
    }


# ---- phases 3 and 4 -------------------------------------------------------------

def _state_finite(state):
    import torch
    return all(bool(torch.isfinite(v.data).all())
               for part in state for group in part.values() for v in group.values())


def _max_state_diff(a, b):
    diffs = {}
    for group in ("qem_params", "qem_means"):
        for k, v in a[group].items():
            w = b[group][k].with_dims_front(list(v.dims))
            diffs[k] = (v.data - w.data).abs().max().item()
    return diffs


def phase_main_path():
    import torch
    from alan_tpu_torch import train
    from alan_tpu_torch.models import movielens as ml
    from alan_tpu_torch.ops import lowrank as lr
    from alan_tpu_torch.ops import lowrank_kernel as lk
    from alan_tpu_torch.utils import assert_full_f32

    ps, data, cov = ml.load_data_covariates(seed=0, M=ml.M, N=ml.N, device="cuda")
    problem = ml.grouped_problem(ps, data, cov, device="cuda")
    step, state = train.qem(problem, K_MAIN, lr=0.1)
    assert_full_f32(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(1)

    state, _ = step(state, gen)                # warm-up (cuBLAS handles, caches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lk.FWD_LAUNCHES = lk.BWD_LAUNCHES = 0
    lr.CONTRACT_CALLS = 0
    elbos = []
    t0 = time.perf_counter()
    for _ in range(QEM_STEPS):
        state, elbo = step(state, gen)
        elbos.append(elbo)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / QEM_STEPS * 1e3
    launches = {"fwd": lk.FWD_LAUNCHES, "bwd": lk.BWD_LAUNCHES}
    contract_calls = lr.CONTRACT_CALLS
    elbos = [float(e) for e in elbos]
    res = {"phase": "main_path", "model": "grouped_movielens", "M": ml.M, "N": ml.N,
           "d_z": ml.d_z, "K": K_MAIN, "steps": QEM_STEPS, "ms_per_step": ms,
           "elbos": elbos, "launches": launches, "contract_calls": contract_calls,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "ok": True}
    if not all(map(lambda e: e == e and abs(e) != float("inf"), elbos)):
        res["ok"] = False
        fail("main_path", f"non-finite ELBO {elbos}")
    if not _state_finite(state):
        res["ok"] = False
        fail("main_path", "non-finite state")
    if launches["fwd"] < 1 or launches["bwd"] < 1:
        res["ok"] = False
        fail("main_path", f"a kernel never ran on the main path: {launches}")
    emit(res)

    _profile_step(step, state, gen, ms)
    return problem, step, state, launches


def _profile_step(step, state, gen, ms_per_step):
    """Device time by kernel name over two QEM steps (torch.profiler).

    Device activity is every CUDA event that is not a user annotation: the
    profiler also puts each operator's name on the device timeline, and
    counting those would count the kernels under them twice.  Busy time is
    the union of the activity intervals.  The profiler slows the host, so
    the idle share is given over the profiled window and, with the busy time
    per step, over the unprofiled step time of the main_path phase."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    steps = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def on_device(ev):
        return (ev.device_type == DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False))

    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events() if on_device(ev))
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages() if on_device(ev)), reverse=True)
    busy_ms = busy_us / 1e3
    emit({"phase": "profile", "steps": steps, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms, "device_events": len(spans),
          "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
          "device_idle_share_unprofiled":
              max(0.0, 1.0 - busy_ms / steps / ms_per_step),
          "top": [{"kernel": k[:90], "ms": us / 1e3, "calls": c}
                  for us, k, c in rows[:12]]})


def phase_cross_check(problem, step, state):
    import torch
    from alan_tpu_torch.sampler import PermutationSampler
    gen = torch.Generator(device="cuda").manual_seed(2)
    tree, _ = problem.Q._sample(K_MAIN, False, PermutationSampler,
                                problem.all_platedims, gen, state=state[1])
    (newP_k, newQ_k), elbo_k = step(state, sample=tree)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    os.environ["ALAN_TPU_NO_LAZY_LOWRANK"] = "1"
    try:
        (newP_d, newQ_d), elbo_d = step(state, sample=tree)
        torch.cuda.synchronize()
    finally:
        del os.environ["ALAN_TPU_NO_LAZY_LOWRANK"]
    dense_ms = (time.perf_counter() - t0) * 1e3
    elbo_k, elbo_d = float(elbo_k), float(elbo_d)
    rel = abs(elbo_k - elbo_d) / abs(elbo_d)
    diffs = _max_state_diff(newQ_k, newQ_d)
    state_ok = all(
        torch.allclose(v.data, newQ_d[g][k].with_dims_front(list(v.dims)).data,
                       rtol=1e-4, atol=1e-4)
        for g in ("qem_params", "qem_means") for k, v in newQ_k[g].items())
    res = {"phase": "cross_check", "elbo_kernel": elbo_k, "elbo_dense": elbo_d,
           "elbo_rel_diff": rel, "max_state_abs_diff": max(diffs.values()),
           "worst_state_entry": max(diffs, key=diffs.get),
           "dense_step_ms_one_call": dense_ms,
           "ok": rel <= 1e-4 and state_ok}
    if not res["ok"]:
        fail("cross_check", f"ELBO rel diff {rel}, state diffs {diffs}")
    emit(res)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", os.environ["CUDA_VISIBLE_DEVICES"],
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def main():
    # one card: the first visible one, so that device_count() is 1
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    os.environ["CUDA_VISIBLE_DEVICES"] = first
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to drive",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import alan_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = nvidia_smi_line()
    phase_build()
    timing = phase_kernels()
    problem, step, state, launches = phase_main_path()
    phase_cross_check(problem, step, state)

    emit({"kernels": [
        dict(name="lowrank_lse_fwd", route="cuda",
             source="alan_tpu_torch/csrc/lowrank_lse.cu",
             replaces="alan_tpu/ops/pallas_lowrank.py:215",
             launches=launches["fwd"], library_ms=None, **timing["fwd"]),
        dict(name="lowrank_lse_bwd", route="cuda",
             source="alan_tpu_torch/csrc/lowrank_lse.cu",
             replaces="alan_tpu/ops/pallas_lowrank.py:298",
             launches=launches["bwd"], library_ms=None, **timing["bwd"]),
    ]})
    print(card, flush=True)
    if FAILURES:
        for f in FAILURES:
            print(f"chip_smoke FAILED {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
