"""Moments-paper IS sweep: MP against global importance sampling, moment
accuracy over K (the port's counterpart of ``examples/runner_moments_IS.py``,
the flagship experiment of arXiv:2310.17374: the MP estimator's moment MSE
decays polynomially faster in K than one global importance sample's).

    python -m alan_tpu_torch.runner_moments_IS --model movielens \\
        --mp-Ks 3 10 30 100 300 --is-Ks 10 100 1000 10000 100000 1000000 \\
        --runs 20 --out results/moments_IS_movielens.json [--device cpu]

Per (method, K): ``runs`` independent estimates of every latent's mean from
an untrained Q (``Q_param_type="opt"``: the proposals are the prior), then

* ``var_mse``  -- the across-run variance of the estimate (unbiased sample
  variance about the across-run mean),
* ``fake_mse`` -- the squared error against the latents the fake data were
  drawn from (``return_fake_latents``),

each summed over a latent's coordinates, with their totals, and ``run_s``,
the wall time of a run (the first run, which builds the kernels and the
planner's paths, included).  Global IS at large K streams through
``sample_nonmp.nonmp_moments_streaming`` in chunks of at most ``chunk``
particles (rounded down to a divisor of K).  Run r at K draws its
particles from a generator seeded ``fold_seed(fold_seed(seed + 1, K), r)``
(MP; ``seed + 2`` for IS), the port's stand-in for the reference's folded
keys.  The per-run estimate runs eagerly; beside ``run_s`` the record has
``steady_run_s`` (the runs after the first), ``busy_s`` (the card's busy
time in one more, profiled run) and ``idle_share`` (1 - busy_s /
steady_run_s; None on the CPU).  A K that fails is recorded as its
``error``, and the JSON is written after each K.
"""
from __future__ import annotations

import argparse
import importlib
import json
import time

import numpy as np


def _latent_moment_list(problem):
    """``([((name,), mean), ...], names)`` of every latent of Q (its data
    left out)."""
    from .ir import Data, Plate
    from .moments import mean
    data_names = set()

    def walk(plate):
        for k, v in plate.flat_prog.items():
            if isinstance(v, Plate):
                walk(v)
            elif isinstance(v, Data):
                data_names.add(k)
    walk(problem.Q.plate)
    latents = [n for n in problem.Q.plate.varname2groupvarname() if n not in data_names]
    return [((n,), mean) for n in latents], latents


def make_mp_fn(problem, K, split=None):
    """``f(seed) -> [DT]``: the MP estimate of each latent's mean from K
    particles drawn from a generator seeded ``seed`` (source-term
    moments, ``Sample._moments_uniform_input``)."""
    from .split import Split, no_checkpoint
    from .utils import seeded_generator
    strategy = Split(*split) if split else no_checkpoint
    moment_list, _ = _latent_moment_list(problem)

    def f(seed):
        s = problem.sample(K, seeded_generator(seed, problem.device), reparam=False)
        return s._moments_uniform_input(moment_list, computation_strategy=strategy)
    return f


def is_chunk(K, chunk):
    """The largest divisor of K that takes at most ``ceil(K / chunk)``
    pieces (``examples/runner_moments_IS.py``'s rounding)."""
    chunk = min(chunk, K)
    n = -(-K // chunk)
    while K % n:
        n += 1
    return K // n


def make_is_fn(problem, K, chunk):
    """``f(seed) -> [DT]``: the global IS estimate of each latent's mean
    from K joint particles, streamed in :func:`is_chunk` pieces, chunk c
    drawn from ``fold_seed(seed, c)``."""
    from .sample_nonmp import nonmp_moments_streaming
    moment_list, _ = _latent_moment_list(problem)
    chunk = is_chunk(K, chunk)

    def f(seed):
        return nonmp_moments_streaming(problem, K, chunk, moment_list, seed)[0]
    return f


def sweep_record(ests, truth, latents, runs, run_s):
    """The record of one (method, K) from ``ests`` (a list over runs of
    lists over ``latents`` of numpy estimates) and ``truth`` (latent ->
    numpy array): ``examples/runner_moments_IS.py``'s arithmetic."""
    rec = {"run_s": run_s, "var_mse": {}, "fake_mse": {}}
    for i, n in enumerate(latents):
        stack = np.stack([e[i] for e in ests])     # (runs, ...)
        gm = stack.mean(axis=0)
        var = ((stack - gm) ** 2).mean(axis=0).sum()
        rec["var_mse"][n] = float(var * runs / max(runs - 1, 1))
        if truth[n].shape == stack.shape[1:]:
            rec["fake_mse"][n] = float(((stack - truth[n]) ** 2).mean(axis=0).sum())
    rec["var_mse_total"] = float(sum(rec["var_mse"].values()))
    rec["fake_mse_total"] = float(sum(rec["fake_mse"].values()))
    return rec


def _truth(problem, fake_latents, latents):
    """``(truth, dims)``: each latent's generating value over the training
    plates (sliced where the fake data's plates are longer), as numpy,
    and its dims."""
    from .dims import as_dt, slice_dim
    truth, dims = {}, {}
    for n in latents:
        t = as_dt(fake_latents[n])
        for d in t.dims:
            tr = problem.all_platedims.get(d)
            if tr is not None and t.dim_size(d) > tr:
                t = slice_dim(t, d, 0, tr)
        truth[n] = t.data.detach().cpu().numpy()
        dims[n] = t.dims
    return truth, dims


def _numpy(m, dims):
    """An estimate as numpy, its dims in the order of ``dims``."""
    return m.with_dims_front([d for d in dims if d in m.dims]).data.detach().cpu().numpy()


def sweep(model_name, mp_Ks, is_Ks, runs=20, seed=0, chunk=30000, split=None,
          out=None, mp_split_min_K=0, device="cuda"):
    from .profiling import device_busy
    from .utils import fold_seed, resolve_device
    device = resolve_device(device)
    model = importlib.import_module(f"alan_tpu_torch.models.{model_name}")
    problem, _, _, _, fake_latents = model.load_and_generate_problem(
        seed=seed, Q_param_type="opt", return_fake_latents=True, device=device)
    _, latents = _latent_moment_list(problem)
    truth, dims = _truth(problem, fake_latents, latents)

    result = {"model": model_name, "runs": runs, "latents": latents,
              "chunk": chunk, "mp": {}, "global_is": {}, "device": str(device)}

    def one_method(tag, Ks, make_fn):
        for K in Ks:
            try:
                f = make_fn(K)
                base = fold_seed(seed + (1 if tag == "mp" else 2), K)

                def estimate(r):
                    return [_numpy(m, dims[n]) for m, n in zip(f(fold_seed(base, r)), latents)]
                ests, times = [], []
                for r in range(runs):
                    t0 = time.perf_counter()
                    ests.append(estimate(r))
                    times.append(time.perf_counter() - t0)
                rec = sweep_record(ests, truth, latents, runs, sum(times) / runs)
                steady = sum(times[1:]) / (runs - 1) if runs > 1 else times[0]
                _, busy = device_busy(lambda: estimate(runs), device)
                rec.update(steady_run_s=steady, busy_s=busy,
                           idle_share=None if busy is None else max(0.0, 1 - busy / steady))
                result[tag][str(K)] = rec
                print(f"{tag} K={K}: var_mse={rec['var_mse_total']:.4g} "
                      f"fake_mse={rec['fake_mse_total']:.4g} "
                      f"run_s={rec['run_s']:.3f}", flush=True)
            except Exception as e:      # a K that fails is recorded, as the reference's
                result[tag][str(K)] = {"error": f"{type(e).__name__}: {e}"}
                print(f"{tag} K={K}: FAILED {type(e).__name__}: {e}", flush=True)
            if out:
                with open(out, "w") as fh:
                    json.dump(result, fh, indent=1)

    one_method("mp", mp_Ks,
               lambda K: make_mp_fn(problem, K, split if K >= mp_split_min_K else None))
    one_method("global_is", is_Ks, lambda K: make_is_fn(problem, K, chunk))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--model", required=True)
    ap.add_argument("--mp-Ks", nargs="+", type=int, default=[3, 10, 30, 100, 300])
    ap.add_argument("--is-Ks", nargs="+", type=int,
                    default=[10, 100, 1000, 10000, 100000, 1000000])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--chunk", type=int, default=30000)
    ap.add_argument("--split", nargs=2, default=None, metavar=("PLATE", "SIZE"),
                    help="Split(plate, size) for the MP estimator")
    ap.add_argument("--mp-split-min-K", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    split = (a.split[0], int(a.split[1])) if a.split else None
    r = sweep(a.model, a.mp_Ks, a.is_Ks, a.runs, a.seed, a.chunk, split, a.out,
              a.mp_split_min_K, device=a.device)
    print(json.dumps({t: {k: v.get("var_mse_total", v.get("error"))
                          for k, v in r[t].items()}
                      for t in ("mp", "global_is")}, indent=1))


if __name__ == "__main__":
    main()
