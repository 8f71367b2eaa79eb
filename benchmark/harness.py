"""The benchmark's driver: one run of one cell.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration and a
traffic mix, and the harness finds everything else by those names:

* ``configs/<config>.json`` -- the configuration as it is run (sizes, data
  seed, precision);
* ``configs/<config>.py`` -- its data recipe, its problem built with the
  port's model code, the shapes and FLOPs the per-layer readers count, and
  ``record``, which reads a program state into named leaves;
* ``configs/<config>_reference.py`` -- the plain reference, which imports
  nothing of the program;
* ``traffic/<traffic>.json`` -- the training method, K, the learning rate,
  Q's variant, the warm-up and the steps a replayed chunk holds;
* ``workloads/<cell>.json`` -- the limits of the numbers that decide
  ``correct``;
* ``metrics/<metric>.py`` -- a per-layer metric's reader, ``read(ctx)``,
  which returns a number or None.

A run: make the data, build the problem and the step.  The check's
program side comes first, with ``--seed``'s draws from the initial state:
``CHECKED_STEPS`` steps one captured replay at a time, recording the
state after each (the per-step states that ``first_gap`` and
``change_gap`` compare), then one chunk of the window's own captured call,
whose state is carried between replays as in the window (its ELBOs are
held to ``elbo_gap`` with the one-by-one steps').  Then the warm-up from
the initial state through the window's own call with draws seeded
``WARM_SEED`` (so the warm state is the same for every ``--seed``); then
chunks back to back for ``seconds``, each from the warm state with the
next draws of ``--seed``'s generator (closed loop: at most two chunks in
flight, no host work between the steps of a chunk), synchronise, and,
with ``trace``, profile about ``TRACE_SECONDS`` of chunks more.  Every
seed's window does the same work, in distribution: the training state, on
which covid's joint-shift fix-ups depend, does not drift through the
window.  Then the program is freed and the reference follows the checked
steps from the same seed.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

from . import check, trace as trace_mod
from .peaks import peaks_for

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
#: top-level modules that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "alan_tpu")
#: steps from the initial state that the reference follows
CHECKED_STEPS = 3
#: the seed of the warm-up's draws: the same warm state for every --seed
WARM_SEED = 0
#: seconds of chunks that a traced run profiles after its window
TRACE_SECONDS = 1.0


class NoDevice(RuntimeError):
    """The run asks for more cards than the machine has."""


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def cell_spec(name, benchmark=None):
    """Everything a run of cell ``name`` reads, found by name."""
    bench = benchmark or _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = configs[cell["config"]]
    listed = lambda m: "workloads" not in m or name in m["workloads"]
    return {
        "cell": cell,
        "config": _json(os.path.join(ROOT, config["file"])),
        "config_dir": os.path.dirname(os.path.join(ROOT, config["file"])),
        "traffic": _json(os.path.join(BENCH, "traffic", f"{cell['traffic']}.json")),
        "workload": _json(os.path.join(BENCH, "workloads", f"{name}.json")),
        "end_to_end": [m for m in bench["end_to_end"] if listed(m)],
        "per_layer": [m for m in bench["per_layer"] if listed(m)],
    }


def reader(metric_name):
    """The reader module of a per-layer metric."""
    return load_module(os.path.join(BENCH, "metrics", f"{metric_name}.py"),
                       f"bench_metric_{metric_name.replace('.', '_')}")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def smi():
    """``nvidia-smi``'s reading of the card: name, SM clock, power draw and
    limit, temperature (a string; empty where it cannot run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _number(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def run_cell(name, seed, seconds, trace, t_start, device="cuda", spec=None,
             warn=_log, trace_seconds=TRACE_SECONDS):
    """One run of cell ``name``: the result line as a dict.  ``spec``
    replaces the cell's files and ``trace_seconds`` the traced length (the
    tests run cut sizes on the CPU)."""
    spec = spec or cell_spec(name)
    cfg, traffic, cell = spec["config"], spec["traffic"], spec["cell"]
    phases = {}
    t = time.perf_counter()

    import torch
    from alan_tpu_torch import train
    from alan_tpu_torch.ops import logmmexp_kernel
    phases["imports_s"] = time.perf_counter() - t

    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < cell["chips"]):
        raise NoDevice(f"cell {name} takes {cell['chips']} card(s); "
                       f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                       f"present")
    torch.set_num_threads(min(4, torch.get_num_threads()))
    if on_card:
        t = time.perf_counter()
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
        phases["cuda_init_s"] = time.perf_counter() - t
        from alan_tpu_torch import _build
        t = time.perf_counter()
        for build in _build.start_all():
            build.wait()
        phases["extensions_s"] = time.perf_counter() - t

    config_mod = load_module(os.path.join(spec["config_dir"], f"{cfg['name']}.py"),
                             f"bench_config_{cfg['name']}")
    t = time.perf_counter()
    data = config_mod.make_data(cfg)
    phases["data_s"] = time.perf_counter() - t

    t = time.perf_counter()
    problem = config_mod.build(cfg, data, traffic, device)
    factory = getattr(train, traffic["method"])
    step, state0 = factory(problem, traffic["K"], lr=traffic["lr"], device=device)
    phases["problem_s"] = time.perf_counter() - t

    joint = None
    if trace:
        # the fix-up kernels add to this counter inside every replay
        joint = torch.zeros((), dtype=torch.int64, device=device)
        logmmexp_kernel.JOINT_COUNT = joint

    seeded = lambda n: torch.Generator(device=device).manual_seed(int(n))
    counted = lambda: int(joint) if joint is not None else None
    gen = seeded(seed)
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    t = time.perf_counter()
    single = train.scan_steps(step, 1)
    state = state0
    records, first_elbos, checked_joint = [config_mod.record(state, traffic)], [], []
    capture = 0.0
    for _ in range(CHECKED_STEPS):
        if joint is not None:
            joint.zero_()
        state, elbos = single(state, gen)
        capture += single.capture_seconds
        first_elbos.append(float(elbos[0]))
        records.append(config_mod.record(state, traffic))
        checked_joint.append(counted())
    if joint is not None:
        # the first call also ran its capture's eager warm-up on the same
        # draws and state, so it counted the first step twice
        checked_joint[0] //= 2
    del single
    gc.collect()
    # the window's own call from the initial state, on the same draws
    run = train.scan_steps(step, traffic["chunk"])
    if joint is not None:
        joint.zero_()
    _, elbos = run(state0, seeded(seed))
    carried_elbos = [float(e) for e in elbos[:CHECKED_STEPS]]
    if joint is not None:
        # less the capture's eager warm-up, which ran the first step again
        chunk_joint = (counted() - checked_joint[0]) / traffic["chunk"]
    phases["checked_steps_s"] = time.perf_counter() - t
    capture += run.capture_seconds

    # the warm state: the same for every --seed, reached through the
    # window's own captured call
    t = time.perf_counter()
    warm_gen = seeded(WARM_SEED)
    warm, warm_elbos = state0, []
    for _ in range(traffic["warm_chunks"]):
        warm, elbos = run(warm, warm_gen)
        warm_elbos.append(elbos)
    sync()
    phases["warm_s"] = time.perf_counter() - t
    phases["capture_s"] = capture
    warm_steps = traffic["warm_chunks"] * traffic["chunk"]
    setup_s = time.perf_counter() - t_start
    warn(json.dumps({"setup_phases": {k: round(v, 4) for k, v in phases.items()},
                     "setup_s": setup_s, "warm_steps": warm_steps}))
    if joint is not None:
        warn(json.dumps({"checked_joint_entries": checked_joint,
                         "carried_chunk_joint_entries_per_step": chunk_joint}))
    warn(json.dumps({"smi_before_window": smi()}))

    # ---- the window ------------------------------------------------------
    window_elbos = []

    def replay_for(seconds):
        """Replay chunks back to back, each from the warm state with the
        next draws of ``--seed``'s generator, at most two in flight, until
        ``seconds`` have passed; returns the steps run."""
        pending, steps, start = [], 0, time.perf_counter()
        while True:
            _, elbos = run(warm, gen)
            window_elbos.append(elbos)
            steps += traffic["chunk"]
            if on_card:
                event = torch.cuda.Event()
                event.record()
                pending.append(event)
                if len(pending) > 1:
                    pending.pop(0).synchronize()
            if time.perf_counter() - start >= seconds:
                return steps

    t0 = time.perf_counter()
    steps = replay_for(seconds)
    sync()
    window_s = time.perf_counter() - t0
    warn(json.dumps({"smi_after_window": smi(), "window_s": window_s, "steps": steps}))
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    summary, traced_steps, joint_entries = None, 0, None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        joint.zero_()
        sync()
        with profile(activities=activities) as prof:
            with record_function(trace_mod.WINDOW):
                traced_steps = replay_for(trace_seconds)
                sync()
        joint_entries = int(joint)
        logmmexp_kernel.JOINT_COUNT = None
        summary = trace_mod.summarise(prof) if on_card else None
        del prof

    all_window = torch.cat(window_elbos).float().cpu()
    failed = int((~torch.isfinite(all_window)).sum())
    warm_ok = all(bool(torch.isfinite(e).all()) for e in warm_elbos)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the run loaded {found}")

    # ---- free the program, then the reference ----------------------------
    del run, state, state0, warm, step, problem, warm_elbos, window_elbos
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref_mod = load_module(os.path.join(spec["config_dir"], f"{cfg['name']}_reference.py"),
                          f"bench_reference_{cfg['name']}")
    reference = ref_mod.Reference(cfg, data, traffic, device).run(seed, CHECKED_STEPS)
    program = (first_elbos, [r[0] for r in records], records[1][1])
    numbers, where = check.compare(program, reference, carried=carried_elbos)
    correct, table = check.judge(numbers, spec["workload"]["limits"])
    correct = correct and failed == 0 and warm_ok
    check_s = time.perf_counter() - t
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the run loaded {found}")

    result = {"correct": correct, "attempted": steps + traced_steps, "failed": failed}
    device_name = torch.cuda.get_device_name(device) if on_card else "cpu"
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    metrics = {}
    if not trace:
        values = {"step_ms": window_s / steps * 1e3, "peak_gb": peak / 1e9,
                  "setup_s": setup_s}
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = {"trace": summary, "traced_steps": traced_steps,
               "joint_entries": joint_entries, "config": cfg, "traffic": traffic,
               "shapes": config_mod.shapes(cfg, traffic),
               "step_flops": config_mod.step_flops(cfg, traffic),
               "peaks": peaks_for(device_name)}
        for m in spec["per_layer"]:
            value = reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if on_card else "cpu", "kind": device_name,
                        "count": cell["chips"] if on_card else 0,
                        "memory_peak_bytes": peak}
    if trace and summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": trace_mod.top_kernels(summary),
                               "idle_gaps": summary["idle_gaps"]}
    result["check"] = {k: {"value": _number(v["value"]), "limit": v["limit"]}
                       for k, v in table.items()}
    warn(json.dumps({"check_s": check_s, "worst_leaf": where,
                     "program_elbos": first_elbos, "carried_elbos": carried_elbos,
                     "reference_elbos": reference[0],
                     "window_failed": failed, "warm_finite": warm_ok}))
    for k, v in result["check"].items():
        warn(f"check {k} {v['value']} limit {v['limit']}")
    return result
