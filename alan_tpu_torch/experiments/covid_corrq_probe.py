"""Covid's ``corr_Q`` proposal against a factorised control on the NUTS
gold (the port's counterpart of ``scripts/covid_corrq_probe.py``).

    python -m alan_tpu_torch.experiments.covid_corrq_probe [--device cpu]

The K sweep leaves CM_alpha and Mobility_alpha pinned at every K under a
factorised Q.  This probe fits the ``corr_Q=True`` model (a
full-covariance MultivariateNormal proposal over CM_alpha, the same
posterior) by QEM, 150 steps, ``lr="0.1/t@100"``, at K = 30 and 100,
beside the factorised model on the same data, seed and steps (the JAX
script leaves its control to ``covid_k_sweep.json``; the port runs it
here), each against the cached NUTS gold.  Writes
``covid_corrq_probe.json``: ``arms`` keyed ``corr_Q_K<K>`` and
``factorised_K<K>``.
"""
from __future__ import annotations

import json

import numpy as np

from ..runner_moments import mp_means
from ..utils import resolve_device
from . import covid_recipe as cr

ARMS = (("corr_Q", True), ("factorised", False))


def run(nRs=16, nDs=25, Ks=(30, 100), iters=150, draws=500, warmup=500, chains=4, seed=0,
        max_depth=8, device="cuda", out_dir=cr.RESULTS, arms=ARMS,
        after_step=None):
    """``after_step(arm, K, i)`` runs after each QEM step (``covid_recipe.fit_mp``)."""
    device = resolve_device(device)
    gold, dims, _, nuts_time = cr.load_or_run_gold(nRs, nDs, draws, warmup, chains, seed,
                                                   max_depth, out_dir, device)
    out = {"model": f"covid nRs={nRs} nDs={nDs} (REDUCED; {cr.DATA_NOTE})",
           "iters": iters, "nuts_time_s": nuts_time,
           "factorised_control_note": (
               "the factorised arms fit the same build_problem data, seed and iters "
               "without corr_Q; covid_k_sweep.json holds the same control by K"),
           "arms": {}, "device": cr.card(device)}
    path = cr.record_path(out_dir, "covid_corrq_probe.json")
    for arm, corr in arms:
        for K in Ks:
            problem = cr.build_problem(nRs, nDs, seed, device, corr_Q=corr)
            hook = None if after_step is None else (
                lambda i, arm=arm, K=K: after_step(arm, K, i))
            marg, elbos, mp_time = cr.fit_mp(problem, K, iters, seed, device=device,
                                             after_step=hook)
            tab = cr.z_table(gold, mp_means(marg, dims))
            rec = {"mp_time_s": mp_time,
                   "variables": {name: {"z_median": s["z_median"], "z_max": s["z_max"],
                                        "mse": s["mse"]}
                                 for name, s in ((n, cr.variable_stats(o, gm, z))
                                                 for n, (o, gm, _, z) in tab.items())},
                   "elbo_first_last": elbos[:1] + elbos[-1:],
                   "elbos_finite": bool(np.all(np.isfinite(elbos)))}
            ov = cr.overall([z for *_, z in tab.values()], p90=False)
            if ov is not None:
                rec["overall"] = {k: ov[k] for k in ("z_median", "frac_z_lt_5")}
            out["arms"][f"{arm}_K{K}"] = rec
            print(f"{arm} K={K}:", json.dumps(rec.get("overall")),
                  {v: round(rec["variables"][v]["z_median"], 1)
                   for v in ("CM_alpha", "Mobility_alpha", "RegionR")
                   if v in rec["variables"]}, flush=True)
            cr.write_json(path, out)          # saved after each arm
            del problem, marg
    return out


def main(argv=None):
    ap = cr.parser(__doc__)
    ap.add_argument("--Ks", type=int, nargs="+", default=[30, 100])
    ap.add_argument("--iters", type=int, default=150)
    cr.gold_args(ap)
    a = ap.parse_args(argv)
    r = run(a.nRs, a.nDs, tuple(a.Ks), a.iters, a.draws, a.warmup, seed=a.seed,
            max_depth=a.max_depth, device=a.device, out_dir=a.out_dir)
    print("->", cr.record_path(a.out_dir, "covid_corrq_probe.json"))
    return r


if __name__ == "__main__":
    main()
