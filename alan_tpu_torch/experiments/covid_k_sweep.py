"""Covid's finite-K MP bias against the NUTS gold, and SMC on the same
posterior (the port's counterpart of ``scripts/covid_k_sweep.py``).

    python -m alan_tpu_torch.experiments.covid_k_sweep [--Ks 10 30 100 300] [--device cpu]

1. The NUTS gold of ``moments_vs_hmc_covid`` (the same posterior and seed),
   through the cache in the output directory.
2. SMC with 2048 particles on the same posterior, from a generator seeded
   ``seed + 5``: an independent code path, recorded as
   ``moments_vs_smc_covid.json``.
3. MP QEM at each K, 150 steps each, ``lr="0.1/t@100"``, from fresh
   parameters, read out by ``marginals()`` and recorded by variable and
   overall.  K >= 300 runs under ``Split("nRs", 2)`` as the JAX script
   does; on the card K <= 100 takes the small-K chain kernels and K = 300
   the fused log-matmul.  Each K is written as it finishes, merged into
   an earlier record's ``by_K``.

Writes ``covid_k_sweep.json`` and ``moments_vs_smc_covid.json``.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..runner_moments import mp_means
from ..utils import resolve_device, seeded_generator
from . import covid_recipe as cr


def run_smc_record(nRs, nDs, gold, dims, nuts_time, seed, particles, device):
    """SMC on the gold's posterior against the gold
    (``covid_k_sweep.py:118-158``): the record and the particle draws."""
    from ..models import covid
    from ..smc import run_smc
    ps, cov, data, _ = cr.recipe(nRs, nDs, seed, device)
    cr.sync(device)
    t0 = time.perf_counter()
    samples, info = run_smc(covid.get_P(ps, cov, device=device), data,
                            num_particles=particles,
                            generator=seeded_generator(seed + 5, device))
    cr.sync(device)
    smc_time = time.perf_counter() - t0
    draws = {k: v.with_dims_front(["particle", *dims[k]]).data.cpu().numpy()
             for k, v in samples.items() if k in dims}
    rec = {"model": model_label(nRs, nDs), "sampler": "smc", "num_particles": particles,
           "smc_time_s": smc_time, "nuts_time_s": nuts_time,
           "smc_diag": {"log_Z": float(info["log_Z"]), "stages": int(info["stages"]),
                        "host_syncs": info["host_syncs"],
                        "mean_mutation_accept": info["mean_mutation_accept"],
                        "finite": bool(torch.isfinite(info["theta"]).all())},
           "smc_vs_nuts": {}, "device": cr.card(device)}
    tab = cr.z_table(gold, {k: v.mean(axis=0) for k, v in draws.items()})
    for name, (sm, gm, _, z) in tab.items():
        rec["smc_vs_nuts"][name] = cr.variable_stats(sm, gm, z)
    ov = cr.overall([z for *_, z in tab.values()], p90=False)
    if ov is not None:
        rec["overall"] = ov
    return rec, draws


def model_label(nRs, nDs):
    return (f"covid nRs={nRs} nDs={nDs} (REDUCED, same posterior as "
            f"moments_vs_hmc_covid.json; {cr.DATA_NOTE})")


def run(nRs=16, nDs=25, Ks=(10, 30, 100, 300), iters=150, draws=500, warmup=500, chains=4,
        seed=0, max_depth=8, smc_particles=2048, skip_smc=False, device="cuda",
        out_dir=cr.RESULTS, after_step=None):
    """``after_step(K, i)`` runs after each QEM step (``covid_recipe.fit_mp``)."""
    device = resolve_device(device)
    gold, dims, diag, nuts_time = cr.load_or_run_gold(nRs, nDs, draws, warmup, chains, seed,
                                                      max_depth, out_dir, device)
    if not skip_smc:
        smc_rec, _ = run_smc_record(nRs, nDs, gold, dims, nuts_time, seed, smc_particles,
                                    device)
        cr.write_json(cr.record_path(out_dir, "moments_vs_smc_covid.json"), smc_rec)
        print("SMC-vs-NUTS:", json.dumps(smc_rec.get("overall")), flush=True)
    return mp_sweep(model_label(nRs, nDs), gold, dims, diag, nRs, nDs, Ks, iters, seed,
                    device, out_dir, after_step)


def mp_sweep(label, gold, dims, diag, nRs, nDs, Ks, iters, seed, device, out_dir,
             after_step=None):
    from ..split import Split, no_checkpoint
    sweep = {"model": label, "Ks": list(Ks), "iters": iters,
             "nuts_diag": diag, "by_K": {},
             "gold_diagnostics": cr.gold_diagnostics(gold), "device": cr.card(device)}
    path = cr.record_path(out_dir, "covid_k_sweep.json")
    if os.path.exists(path):        # merge: a rerun of some Ks keeps the others
        prior = cr.read_json(path)
        sweep["by_K"].update(prior.get("by_K", {}))
        sweep["Ks"] = sorted({*prior.get("Ks", []), *Ks})
    for K in Ks:
        problem = cr.build_problem(nRs, nDs, seed, device)     # fresh parameters
        # K = 300's region-broadcast cross-K factor and the fused kernel's
        # kept state need the region plate split in two
        strat = Split("nRs", 2) if K >= 300 else no_checkpoint
        hook = None if after_step is None else (lambda i, K=K: after_step(K, i))
        marg, elbos, mp_time = cr.fit_mp(problem, K, iters, seed, computation_strategy=strat,
                                         device=device, after_step=hook)
        rec = {"mp_time_s": mp_time, **cr.sweep_entry(gold, mp_means(marg, dims)),
               "computation_strategy": "Split('nRs', 2)" if K >= 300 else "no_checkpoint",
               "elbo_first_last": elbos[:1] + elbos[-1:],
               "elbos_finite": bool(np.all(np.isfinite(elbos)))}
        rec.get("overall", {}).pop("n_coords", None)
        sweep["by_K"][str(K)] = rec
        print(f"K={K}:", json.dumps(rec.get("overall")),
              {v: round(rec["variables"][v]["z_median"], 1)
               for v in ("CM_alpha", "Mobility_alpha") if v in rec["variables"]}, flush=True)
        cr.write_json(path, sweep)      # each K saved as it finishes
        del problem, marg
    return sweep


def main(argv=None):
    ap = cr.parser(__doc__)
    ap.add_argument("--nRs", type=int, default=16)
    ap.add_argument("--nDs", type=int, default=25)
    ap.add_argument("--Ks", type=int, nargs="+", default=[10, 30, 100, 300])
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--draws", type=int, default=500)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--smc-particles", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-smc", action="store_true")
    a = ap.parse_args(argv)
    r = run(a.nRs, a.nDs, tuple(a.Ks), a.iters, a.draws, a.warmup, seed=a.seed,
            max_depth=a.max_depth, smc_particles=a.smc_particles, skip_smc=a.skip_smc,
            device=a.device, out_dir=a.out_dir)
    print(json.dumps(r.get("by_K", {}).get(str(a.Ks[-1]), {}).get("overall"), indent=1))
    return r


if __name__ == "__main__":
    main()
