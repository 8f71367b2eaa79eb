"""MP QEM moments on reduced covid against a gold sampler (the port's
counterpart of ``scripts/moments_vs_hmc_covid.py``).

    python -m alan_tpu_torch.experiments.moments_vs_hmc_covid [--device cpu]

Covid at 16 x 25 (20 training days) with :mod:`covid_recipe`'s counts.
The gold is NUTS (or ``--sampler hmc``), 500 warm-up and 500 draws on 4
chains at depth 8, from a generator seeded ``seed + 1`` (for NUTS, the
cache that ``covid_k_sweep`` reads); a second, independent gold run from
one seeded ``seed + 31`` is the self-consistency control: where the two
disagree beyond the same standard error (``nuts_converged_here`` false)
MP's z measures the sampler, not the engine.  MP is QEM at K = 30, 150
steps, ``lr="0.1/t@100"``, read out by ``marginals()``.  Beside the JAX
record's keys the port records each gold run's split R-hat and bulk ESS
(``diagnostics``), the share of transitions that moved a chain, the
gold's dtype (float32, as the JAX script's) and the card.  Writes
``moments_vs_hmc_covid.json``.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..runner_moments import mp_means
from ..utils import resolve_device
from . import covid_recipe as cr


def run(nRs=16, nDs=25, K=30, iters=150, draws=500, warmup=500, chains=4, seed=0,
        sampler="nuts", max_depth=8, device="cuda", out_dir=cr.RESULTS,
        after_step=None):
    device = resolve_device(device)
    if sampler == "nuts":
        gold, dims, diag, gold_time = cr.load_or_run_gold(
            nRs, nDs, draws, warmup, chains, seed, max_depth, out_dir, device)
    else:
        gold, dims, diag, gold_time = cr.run_gold(nRs, nDs, seed, sampler, draws, warmup,
                                                  chains, max_depth, 1, device)
    # the self-consistency control: an independent run from another seed
    gold2, _, diag2, gold2_time = cr.run_gold(nRs, nDs, seed, sampler, draws, warmup,
                                              chains, max_depth, 31, device)

    problem = cr.build_problem(nRs, nDs, seed, device)
    marg, elbos, mp_time = cr.fit_mp(problem, K, iters, seed, device=device,
                                     after_step=after_step)
    mp = mp_means(marg, dims)

    result = {"model": f"covid nRs={nRs} nDs={nDs} (REDUCED; full-size NUTS impractical "
                       f"here; same engine paths; {cr.DATA_NOTE})",
              "sampler": sampler, "K": K, "iters": iters, "draws": draws, "warmup": warmup,
              "chains": chains, "gold_time_s": gold_time, "mp_time_s": mp_time,
              "diag": diag, "variables": {},
              "gold2_time_s": gold2_time, "diag2": diag2,
              "gold_dtype": diag["dtype"], "gold_diagnostics": cr.gold_diagnostics(gold),
              "gold2_diagnostics": cr.gold_diagnostics(gold2),
              "mp_elbo_first_last": elbos[:1] + elbos[-1:],
              "mp_elbos_finite": bool(np.all(np.isfinite(elbos))), "device": cr.card(device)}
    tab = cr.z_table(gold, mp)
    for name, (m, gm, stderr, z) in tab.items():
        z_self = np.abs(np.asarray(gold2[name]).mean(axis=(0, 1)) - gm) / stderr
        result["variables"][name] = {
            "mse": float(np.mean((m - gm) ** 2)),
            "z_max": float(z.max()), "z_median": float(np.median(z)),
            "frac_z_lt_5": float(np.mean(z < 5.0)),
            "nuts_self_z_median": float(np.median(z_self)),
            "nuts_self_frac_z_lt_5": float(np.mean(z_self < 5.0)),
            "nuts_converged_here": bool(np.median(z_self) < 5.0),
        }
    if tab:
        conv = [n for n, v in result["variables"].items() if v["nuts_converged_here"]]
        allz = np.concatenate([z.ravel() for *_, z in tab.values()])
        convz = (np.concatenate([tab[n][3].ravel() for n in conv]) if conv
                 else np.array([]))
        result["overall"] = {
            "n_coords": int(allz.size), "z_median": float(np.median(allz)),
            "z_p90": float(np.percentile(allz, 90)), "frac_z_lt_5": float(np.mean(allz < 5.0)),
            "nuts_converged_vars": conv,
            "z_median_where_nuts_converged": float(np.median(convz)) if convz.size else None,
            "frac_z_lt_5_where_nuts_converged":
                float(np.mean(convz < 5.0)) if convz.size else None}
    return result


def main(argv=None):
    ap = cr.parser(__doc__)
    ap.add_argument("--nRs", type=int, default=16)
    ap.add_argument("--nDs", type=int, default=25)
    ap.add_argument("--K", type=int, default=30)
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--draws", type=int, default=500)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--sampler", default="nuts", choices=["nuts", "hmc"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="moments_vs_hmc_covid.json",
                    help="the record's file name in OUT_DIR")
    a = ap.parse_args(argv)
    r = run(a.nRs, a.nDs, a.K, a.iters, a.draws, a.warmup, seed=a.seed, sampler=a.sampler,
            max_depth=a.max_depth, device=a.device, out_dir=a.out_dir)
    cr.write_json(cr.record_path(a.out_dir, os.path.basename(a.out)), r)
    print(json.dumps(r, indent=1, default=str))
    return r


if __name__ == "__main__":
    main()
