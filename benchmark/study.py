"""The readings that the limits of ``correct`` are set from, for one cell,
in one process (set-up is paid once):

    python3 benchmark/study.py --workload <cell> [--seeds 12] [--control-seeds 3]

* sound: the program's checked steps (one captured replay at a time, and
  the first steps of a chunk of the window's own captured call) against
  the reference, on ``--seeds`` seeds: the lower readings;
* control: the reference in float32 with its matrix products' operands
  rounded to TF32, in the program's place, against the float64 reference;
* faults planted in the program: half of the particles left out (K / 2),
  a step that returns its state unchanged (in the one-by-one steps, and
  in the window's own call, where only the ELBOs show it), one leaf moved
  double.

Prints one JSON line a reading and a summary line last.  Not a benchmark
run: nothing here is timed, and ``run.py`` never runs it.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def carried_elbos(run, state0, seed, steps, device):
    """The first ``steps`` ELBOs of a chunk of ``run`` from ``state0`` on
    ``seed``'s draws."""
    import torch
    _, elbos = run(state0, torch.Generator(device=device).manual_seed(int(seed)))
    return [float(e) for e in elbos[:steps]]


def program_steps(single, state0, seed, steps, record, traffic, device):
    import torch
    gen = torch.Generator(device=device).manual_seed(int(seed))
    state, records, elbos = state0, [record(state0, traffic)], []
    for _ in range(steps):
        state, e = single(state, gen)
        elbos.append(float(e[0]))
        records.append(record(state, traffic))
    return elbos, [r[0] for r in records], records[1][1]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=3_000_000_000)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--config", type=json.loads, default={},
                        help="JSON of configuration keys to replace (a cut size for a test)")
    parser.add_argument("--traffic", type=json.loads, default={},
                        help="JSON of traffic keys to replace")
    args = parser.parse_args(argv)

    import torch
    from alan_tpu_torch import train
    from benchmark import check, harness

    spec = harness.cell_spec(args.workload)
    cfg, traffic = {**spec["config"], **args.config}, {**spec["traffic"], **args.traffic}
    device = torch.device(args.device)
    if device.type == "cuda":
        from alan_tpu_torch import _build
        for b in _build.start_all():
            b.wait()
    config_mod = harness.load_module(os.path.join(spec["config_dir"], f"{cfg['name']}.py"), "cfg")
    ref_mod = harness.load_module(os.path.join(spec["config_dir"], f"{cfg['name']}_reference.py"),
                                  "ref")
    data = config_mod.make_data(cfg)
    problem = config_mod.build(cfg, data, traffic, device)
    factory = getattr(train, traffic["method"])
    n = harness.CHECKED_STEPS
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    emit = lambda d: print(json.dumps(d), flush=True)
    readings = {"sound": [], "control": [], "control_f32": [], "half": [],
                "unchanged": [], "carried_unchanged": [], "double": []}

    def reading(kind, seed, program, reference, seconds=None, carried=None):
        per_leaf = {}
        numbers, where = check.compare(program, reference, per_leaf, carried=carried)
        readings[kind].append(numbers)
        emit({"kind": kind, "seed": seed, **numbers, "where": where, "leaves": per_leaf,
              "program_elbos": program[0], "carried_elbos": carried,
              "reference_elbos": reference[0], "reference_s": seconds})

    step, state0 = factory(problem, traffic["K"], lr=traffic["lr"], device=device)
    single = train.scan_steps(step, 1)
    run = train.scan_steps(step, traffic["chunk"])
    frozen = train.scan_steps(lambda state, gen: (state, step(state, gen)[1]), traffic["chunk"])
    half_step, half_state0 = factory(problem, traffic["K"] // 2, lr=traffic["lr"], device=device)
    half_single = train.scan_steps(half_step, 1)
    Ref = ref_mod.Reference
    for i, seed in enumerate(seeds):
        prog = program_steps(single, state0, seed, n, config_mod.record, traffic, device)
        carried = carried_elbos(run, state0, seed, n, device)
        t = time.perf_counter()
        ref = Ref(cfg, data, traffic, device).run(seed, n)
        if device.type == "cuda":
            torch.cuda.synchronize()
        reading("sound", seed, prog, ref, time.perf_counter() - t, carried=carried)
        if i >= args.control_seeds:
            continue
        control = Ref(cfg, data, traffic, device, dtype=torch.float32, tf32=True).run(seed, n)
        reading("control", seed, control, ref)
        plain32 = Ref(cfg, data, traffic, device, dtype=torch.float32).run(seed, n)
        reading("control_f32", seed, plain32, ref)
        half = program_steps(half_single, half_state0, seed, n, config_mod.record,
                             traffic, device)
        reading("half", seed, half, ref)
        elbos, leaves, first = prog
        unchanged_first = None if first is None else {k: 0 * v for k, v in first.items()}
        reading("unchanged", seed, (elbos, [leaves[0]] * len(leaves), unchanged_first), ref)
        reading("carried_unchanged", seed, prog, ref,
                carried=carried_elbos(frozen, state0, seed, n, device))
        moves = {k: float((leaves[-1][k] - leaves[0][k]).norm()) for k in leaves[0]}
        big = max(moves, key=moves.get)
        doubled = [dict(l, **{big: 2 * l[big] - leaves[0][big]}) for l in leaves]
        reading("double", seed, (elbos, doubled, first), ref)

    summary = {}
    for kind, rows in readings.items():
        if rows:
            pick = max if kind == "sound" else min
            summary[kind] = {k: pick(r[k] for r in rows) for k in check.NAMES}
    emit({"summary": summary, "cell": args.workload, "seeds": seeds,
          "device": torch.cuda.get_device_name() if device.type == "cuda" else "cpu"})
    return summary


if __name__ == "__main__":
    main()
