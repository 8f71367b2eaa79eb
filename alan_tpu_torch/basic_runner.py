"""Minimal training loop without the CLI (the port's counterpart of
``examples/basic_runner.py``): import a model module and call ``run``.

    from alan_tpu_torch import basic_runner
    basic_runner.run('movielens', methods=['qem', 'vi', 'rws', 'global_qem'],
                     K=10, num_iters=100, lrs={'qem': 0.1})

or ``python -m alan_tpu_torch.basic_runner [MODEL] [--device cpu]`` (QEM,
K=10, 50 iterations).
"""
from __future__ import annotations

import argparse
import importlib


def run(model_name, methods=("qem",), K=10, num_runs=1, num_iters=100,
        lrs=None, fake_data=True, seed=0, device="cuda"):
    """``{(model, method, run): elbos}``: each method trained for
    ``num_iters`` steps on the model of run r's data (seed ``seed + r``),
    its particles from a generator seeded ``seed + 100 + r``."""
    from . import train
    from .utils import seeded_generator
    lrs = lrs or {}
    model = importlib.import_module(f"alan_tpu_torch.models.{model_name}")
    results = {}
    for run_idx in range(num_runs):
        for method in methods:
            qtype = "opt" if ("vi" in method or "rws" in method) else "qem"
            problem, *_ = model.load_and_generate_problem(
                seed=seed + run_idx, Q_param_type=qtype, fake_data=fake_data, device=device)
            elbos = train.fit(problem, method=method, K=K, iters=num_iters,
                              lr=lrs.get(method),
                              generator=seeded_generator(seed + 100 + run_idx, problem.device),
                              device=device)
            results[(model_name, method, run_idx)] = elbos
            print(f"{model_name}/{method} run {run_idx}: "
                  f"elbo {float(elbos[0]):.2f} -> {float(elbos[-1]):.2f}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("model", nargs="?", default="movielens")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    return run(args.model, methods=["qem"], K=10, num_iters=50, device=args.device)


if __name__ == "__main__":
    main()
