"""Moment-accuracy harness: MP moments against a gold sampler's (the port's
counterpart of ``examples/runner_moments.py``).

    python -m alan_tpu_torch.runner_moments --model movielens --K 30 \\
        --sampler nuts [--device cpu]

The gold posterior means come from the port's own HMC, NUTS or SMC on the
model's P program (``mcmc.run_hmc``, ``nuts.run_nuts``, ``smc.run_smc``),
in the data's float dtype.  MP is trained by QEM (``train.fit``, K
particles, ``--iters`` steps), and its means read off the marginal weights
of a fresh K-particle sample (``Sample.marginals()``).  The record is
``examples/runner_moments.py``'s: the two times, the sampler's diagnostics
and each latent's mean squared difference of the two sets of means
(:func:`moment_record`); the port adds each latent's largest split R-hat
and smallest bulk ESS (``diagnostics.summary``) to the diagnostics.

The gold draws use a generator seeded ``seed + 1``, the QEM steps one
seeded ``seed + 2`` and the MP sample one seeded ``seed + 3``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import time

import numpy as np
import torch

SAMPLERS = ("hmc", "nuts", "smc")


def moment_record(gold, mp_moments):
    """``{latent: mean squared difference}`` of the gold means and the MP
    means (``examples/runner_moments.py``'s ``moment_mse``): ``gold`` maps
    each latent to its draws laid out (draw, chain, ...), ``mp_moments``
    to its MP mean laid out as the draws' trailing axes; a latent with no
    MP mean, or one of another shape, is left out, as the reference leaves
    it out."""
    out = {}
    for name, draws in gold.items():
        mp = mp_moments.get(name)
        if mp is None:
            continue
        hm = np.asarray(draws).mean(axis=(0, 1))
        mp = np.asarray(mp)
        if hm.shape != mp.shape:
            continue
        out[name] = float(np.mean((hm - mp) ** 2))
    return out


def _numpy(x):
    return x.detach().cpu().numpy()


def gold_draws(problem, sampler, num_samples, num_warmup, seed):
    """``(draws, diagnostics, dims)``: the gold sampler's draws on the
    problem's P and data, each latent a numpy array (draw, chain, ...)
    (SMC's particles as draws of one chain), its plate dims in ``dims``."""
    from .dims import DT
    from .utils import seeded_generator
    gen = seeded_generator(seed + 1, problem.device)
    data = dict(problem._data)
    if sampler == "smc":
        from .smc import run_smc
        samples, info = run_smc(problem.P, data, num_particles=max(num_samples, 256),
                                generator=gen)
        samples = {k: DT(v.data[:, None], ("draw", "chain") + v.dims[1:])
                   for k, v in samples.items()}
        diag = {"log_Z": float(info["log_Z"]), "stages": int(info["stages"])}
    else:
        from .mcmc import run_hmc
        from .nuts import run_nuts
        run_sampler = {"hmc": run_hmc, "nuts": run_nuts}[sampler]
        samples, info = run_sampler(problem.P, data, num_samples=num_samples,
                                    num_warmup=num_warmup, num_chains=4, generator=gen)
        diag = {k: float(v) for k, v in info.items() if k != "theta"}
        from .diagnostics import summary
        diag.update({f"{k}_{name}": v[k] for name, v in summary(samples).items()
                     for k in ("rhat_max", "ess_min")})
    draws = {k: _numpy(v.data) for k, v in samples.items()}
    dims = {k: v.dims[2:] for k, v in samples.items()}
    return draws, diag, dims


def mp_means(marginals, dims):
    """Each latent's MP mean from ``marginals``, its plates in the order of
    ``dims`` (the gold draws'), as numpy."""
    from .moments import mean
    out = {}
    for name, ds in dims.items():
        try:
            m = marginals.moments(name, mean)
        except KeyError:
            continue
        out[name] = _numpy(m.with_dims_front(list(ds)).data if ds else m.data)
    return out


def fit_mp(problem, K, iters, seed, device):
    """QEM for ``iters`` steps (written back into the problem), then the
    marginals of a fresh K-particle sample."""
    from . import train
    from .utils import seeded_generator
    train.fit(problem, method="qem", K=K, iters=iters, lr=0.1,
              generator=seeded_generator(seed + 2, device), device=device)
    s = problem.sample(K, seeded_generator(seed + 3, device), reparam=False)
    return s.marginals()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compare(problem, model_name, K=30, iters=50, hmc_samples=500, hmc_warmup=500, seed=0,
            sampler="hmc"):
    """``(record, gold draws, MP means, plate dims)`` on ``problem``: the
    gold run, then QEM and the MP means (:func:`run`'s work, its pieces
    kept for a caller that checks them)."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}")
    device = problem.device
    t0 = time.perf_counter()
    gold, diag, dims = gold_draws(problem, sampler, hmc_samples, hmc_warmup, seed)
    _sync(device)
    hmc_time = time.perf_counter() - t0

    t0 = time.perf_counter()
    mp = mp_means(fit_mp(problem, K, iters, seed, device), dims)
    _sync(device)
    mp_time = time.perf_counter() - t0

    result = {"model": model_name, "K": K, "iters": iters,
              "hmc_time_s": hmc_time, "mp_time_s": mp_time,
              "hmc_diag": diag, "moment_mse": moment_record(gold, mp),
              "sampler": sampler, "device": str(device)}
    return result, gold, mp, dims


def run(model_name, K=30, iters=50, hmc_samples=500, hmc_warmup=500, seed=0,
        out=None, sampler="hmc", device="cuda"):
    from .utils import resolve_device
    device = resolve_device(device)
    model = importlib.import_module(f"alan_tpu_torch.models.{model_name}")
    problem = model.load_and_generate_problem(seed=seed, Q_param_type="qem",
                                              device=device)[0]
    result = compare(problem, model_name, K, iters, hmc_samples, hmc_warmup, seed,
                     sampler)[0]
    if out:
        with open(out, "w") as fh:
            json.dump(result, fh, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--model", required=True)
    ap.add_argument("--K", type=int, default=30)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--hmc-samples", type=int, default=500)
    ap.add_argument("--sampler", default="hmc", choices=SAMPLERS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    r = run(a.model, a.K, a.iters, a.hmc_samples, seed=a.seed, out=a.out,
            sampler=a.sampler, device=a.device)
    print(json.dumps(r, indent=1, default=str))


if __name__ == "__main__":
    main()
