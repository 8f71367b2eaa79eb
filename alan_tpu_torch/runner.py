"""The port's experiment runner (counterpart of ``examples/runner.py``):

    python -m alan_tpu_torch.runner --model covid --method qem --K 30 --iters 100

Builds a model of ``alan_tpu_torch/models/`` on the card (``--device cpu``
for the host), trains it with ``train``'s step of ``--method``, records
each iteration's ELBO and wall-clock time (``profiling.timed_steps``: the
card synchronised after every step; the first iteration, which builds the
kernels and the planner's paths, is timed apart as ``compile_time_s``),
optionally evaluates the predictive log-likelihood of the held-out data,
and prints one JSON record (written to ``--out`` too).

The particles of iteration i come from one generator seeded ``seed + 1``,
advanced from step to step, so iteration 0's ELBO is
``train.<method>(problem, K)[0](state0, seeded_generator(seed + 1))``'s.

A grid: ``--grid spec.yaml`` expands a spec of ``gridspec``'s schema and
runs every job in this process, one after another, each printing its
record (``python -m alan_tpu_torch.run_grid`` runs them through
``alan-grid`` instead, one process a job).

Sharding (under ``torchrun``): ``--mesh p=2,t=4 --shard nRs=p,nDs=t
[--shard-all-k p]`` maps dim names onto a mesh over the process group's
ranks (``parallel/mesh.py``); every rank runs the step and rank 0 prints.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

METHODS = ("vi", "rws", "qem", "global_vi", "global_rws", "global_qem")
DEFAULT_LR = {"vi": 0.01, "rws": 0.01, "qem": 0.1,
              "global_vi": 0.01, "global_rws": 0.01, "global_qem": 0.1}


def load_model(name, seed, Q_param_type, device, data_dir=None):
    """``(problem, all_data, all_covariates, all_platesizes)`` of the model
    ``alan_tpu_torch/models/<name>.py`` (the last three None where the
    model has no held-out part), through its ``load_and_generate_problem``:
    fake data drawn from ``seed``, or the reference's files in
    ``data_dir``."""
    model = importlib.import_module(f"alan_tpu_torch.models.{name}")
    kw = {"fake_data": False, "data_dir": data_dir} if data_dir else {}
    return model.load_and_generate_problem(seed=seed, Q_param_type=Q_param_type,
                                           device=device, **kw)


def _pq_of(state, method):
    if method in ("vi", "rws", "global_vi", "global_rws"):
        stateP, stateQ, _ = state
    else:
        if len(state) == 2 and not isinstance(state[1], dict):
            state, _ = state          # qem lr schedule: ((sP, sQ), t)
        stateP, stateQ = state
    return stateP, stateQ


def _mesh_plan(mesh_spec, shard_spec, shard_all_k, device):
    from .parallel.distributed import initialize
    from .parallel.mesh import MeshPlan, make_mesh
    import torch.distributed as dist
    if not dist.is_initialized() and not initialize(device_type=device.type):
        raise RuntimeError("--mesh needs a process group: run under torchrun "
                           "(MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE)")
    axes = {k: int(v) for k, v in (kv.split("=") for kv in mesh_spec.split(","))}
    dim2axis = {} if not shard_spec else dict(kv.split("=") for kv in shard_spec.split(","))
    plan = MeshPlan(make_mesh(axes, device_type=device.type), dim2axis)
    return plan.with_all_K(shard_all_k) if shard_all_k else plan


def _peak_memory(device):
    from .profiling import device_memory_stats
    if device.type != "cuda":
        return None
    stats = device_memory_stats().get(f"cuda:{device.index or 0}")
    return None if stats is None else stats.get("allocated_bytes.all.peak")


def run(model_name, method="qem", K=30, iters=100, lr=None, predll_N=0,
        Q_param_type=None, split=None, seed=0, out=None, predll_every=0,
        fuse_iters=False, runs=1, data_dir=None, mesh_spec=None,
        shard_spec=None, shard_all_k=None, device="cuda"):
    from . import train, Split, no_checkpoint
    from .predict import predictive_ll_fn
    from .profiling import timed_steps
    from .utils import resolve_device, seeded_generator

    device = resolve_device(device)
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    qtype = Q_param_type or ("opt" if "vi" in method or "rws" in method else "qem")
    if ("vi" in method or "rws" in method) and qtype == "qem":
        qtype = "opt"
    problem, all_data, all_cov, all_ps = load_model(model_name, seed, qtype, device,
                                                    data_dir)
    lr = lr if lr is not None else DEFAULT_LR[method]
    mesh_plan = (_mesh_plan(mesh_spec, shard_spec, shard_all_k, device)
                 if mesh_spec else None)

    factory = getattr(train, method)
    if method.startswith("global"):
        if mesh_plan is not None:
            raise ValueError("--mesh is not supported for global_* methods")
        if split:
            raise ValueError("--split is not supported for global_* methods")
        kwargs = {}
    else:
        kwargs = {"computation_strategy": Split(*split) if split else no_checkpoint,
                  "mesh_plan": mesh_plan}
    step, state = factory(problem, K, lr=lr, device=device, **kwargs)

    pll_f = None
    if predll_N and predll_every:
        if all_data is None:
            raise ValueError(f"model {model_name!r} has no held-out data")
        pll_f = predictive_ll_fn(problem, K=K, N=predll_N,
                                 extended_platesizes=dict(all_ps))
    p_lls, predll_iters = [], []

    def eval_pll(i, state):
        # its time is kept out of iter_times, as the reference keeps it
        if pll_f is None or i % predll_every:
            return
        stateP, stateQ = _pq_of(state, method)
        pll = pll_f(stateP, stateQ, all_cov, all_data,
                    seeded_generator(seed + 2 + i, device))
        p_lls.append(float(sum(float(v) for v in pll.values())))
        predll_iters.append(i)

    gen = seeded_generator(seed + 1, device)
    per_run_elbos = None
    if fuse_iters or runs > 1:
        if predll_every:
            raise ValueError("--predll-every needs the eager per-iteration "
                             "loop; drop --fuse-iters/--runs")
        state0 = state
        loop = (train.vmap_runs(step, iters, runs) if runs > 1
                else train.scan_steps(step, iters))
        arg = seed + 1 if runs > 1 else gen
        t0 = time.perf_counter()
        state, elbos_t = loop(state0, arg)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        compile_time = time.perf_counter() - t0
        if runs == 1:
            gen = seeded_generator(seed + 1, device)
            arg = gen
        t0 = time.perf_counter()
        state, elbos_t = loop(state0, arg)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        total = time.perf_counter() - t0
        compile_time -= total
        iter_times = [total / (iters * runs)] * iters
        e = elbos_t.cpu()
        if runs > 1:
            per_run_elbos = e.tolist()
            best = int(e[:, -1].argmax())
            state = train.run_state(state, best)
            elbos = e[best].tolist()
        else:
            elbos = e.tolist()
    else:
        # the first iteration builds the kernels and the planner's paths
        state, outs, times = timed_steps(step, state, [gen])
        compile_time = times[0]
        elbos, iter_times = [float(outs[0])], [0.0]
        eval_pll(0, state)
        for i in range(1, iters):
            state, outs, times = timed_steps(step, state, [gen])
            elbos.append(float(outs[0]))
            iter_times.append(times[0])
            eval_pll(i, state)

    stateP, stateQ = _pq_of(state, method)
    problem.P.set_state(stateP)
    problem.Q.set_state(stateQ)

    result = {
        "model": model_name, "method": method, "K": K, "lr": lr,
        "iters": iters, "device": str(device),
        "device_kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else "cpu"),
        "compile_time_s": compile_time,
        "mean_iter_time_s": (sum(iter_times[1:]) / (iters - 1)) if iters > 1 else None,
        "elbo_start": elbos[0], "elbo_end": elbos[-1],
        "elbos": elbos, "iter_times": iter_times, "seed": seed,
        "peak_memory_bytes": _peak_memory(device),
    }
    if split:
        result["split"] = list(split)
    if mesh_plan is not None:
        result["mesh"] = mesh_spec
        result["shard"] = shard_spec
    if runs > 1:
        result["runs"] = runs
        result["per_run_elbos"] = per_run_elbos
    if fuse_iters or runs > 1:
        result["fused_loop"] = True
    if p_lls:
        result["p_lls"] = p_lls
        result["predll_iters"] = predll_iters

    if predll_N:
        if all_data is None:
            raise ValueError(f"model {model_name!r} has no held-out data")
        t0 = time.perf_counter()
        f = predictive_ll_fn(problem, K=K, N=predll_N, extended_platesizes=dict(all_ps))
        pll = f(problem.P.state(), problem.Q.state(), all_cov, all_data,
                seeded_generator(seed + 2, device))
        result["predictive_ll"] = {k: float(v) for k, v in pll.items()}
        result["predll_time_s"] = time.perf_counter() - t0

    if out:
        with open(out, "w") as fh:
            json.dump(result, fh, indent=1)
    return result


def _parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--grid", default=None, metavar="SPEC",
                    help="a YAML or JSON grid spec (alan_tpu_torch.gridspec's "
                         "schema): run every expanded job in this process, one "
                         "after another; the other flags are ignored, but for "
                         "--device, the device of jobs that name no platform")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--model", default=None,
                    help="a module of alan_tpu_torch/models (covid, movielens, "
                         "radon, ...); required unless --grid is given")
    ap.add_argument("--method", default="qem", choices=METHODS)
    ap.add_argument("--K", type=int, default=30)
    ap.add_argument("--iters", type=int, default=100)

    def _lr(v):
        try:
            return float(v)
        except ValueError:
            return v          # qem schedule string, e.g. "0.1/t@200"
    ap.add_argument("--lr", type=_lr, default=None,
                    help="learning rate; for --method qem also a schedule "
                         "string: '1/t' or '<lr0>/t@<T0>'")
    ap.add_argument("--predll-N", type=int, default=0)
    ap.add_argument("--predll-every", type=int, default=0,
                    help="record a predictive-LL trajectory every E iters "
                         "(time excluded from iter_times)")
    ap.add_argument("--Q-param-type", default=None, choices=[None, "opt", "qem"])
    ap.add_argument("--split", nargs=2, metavar=("PLATE", "SIZE"), default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fuse-iters", action="store_true",
                    help="run the loop through train.scan_steps (CUDA graphs "
                         "on the card, the eager loop on the CPU)")
    ap.add_argument("--runs", type=int, default=1,
                    help="this many independent runs (train.vmap_runs)")
    ap.add_argument("--data-dir", default=None,
                    help="load the real dataset from this directory")
    ap.add_argument("--mesh", default=None, metavar="AXIS=N,...",
                    help="device mesh axes, e.g. p=2,t=4 (under torchrun)")
    ap.add_argument("--shard", default=None, metavar="DIM=AXIS,...",
                    help="map dim names to mesh axes, e.g. nRs=p,nDs=t")
    ap.add_argument("--shard-all-k", default=None, metavar="AXIS",
                    help="also shard every K-dim over this axis")
    return ap


def _run_args(args):
    split = (args.split[0], int(args.split[1])) if args.split else None
    return run(args.model, args.method, args.K, args.iters, args.lr,
               args.predll_N, args.Q_param_type, split, args.seed, args.out,
               predll_every=args.predll_every, fuse_iters=args.fuse_iters,
               runs=args.runs, data_dir=args.data_dir, mesh_spec=args.mesh,
               shard_spec=args.shard, shard_all_k=args.shard_all_k,
               device=args.device)


def _grid_jobs(ap, args):
    """The argv lists of ``--grid``'s expanded jobs, each with a
    ``--device`` (the command line's where the job names no platform),
    and their parsed arguments; jobs on different devices are refused, as
    ``examples/runner.py`` refuses mixed platforms."""
    from .gridspec import expand, load_spec
    argvs = [argv if "--device" in argv else [*argv, "--device", args.device]
             for argv in expand(load_spec(args.grid))]
    jobs = [ap.parse_args(argv) for argv in argvs]
    devices = {job.device for job in jobs}
    if len(devices) > 1:
        ap.error(f"--grid jobs ask for different devices ({sorted(devices)}); "
                 f"run a mixed spec through python -m alan_tpu_torch.run_grid "
                 f"(one process a job) instead")
    return argvs, jobs


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    if args.grid:
        runs = list(zip(*_grid_jobs(ap, args)))
    elif args.model is None:
        ap.error("--model is required (unless --grid is given)")
    else:
        runs = [(None, args)]
    import torch.distributed as dist
    for i, (job_argv, job) in enumerate(runs):
        if job_argv is not None:
            print(f"[grid {i + 1}] python -m alan_tpu_torch.runner " + " ".join(job_argv),
                  file=sys.stderr, flush=True)
        result = _run_args(job)
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(json.dumps(result), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
