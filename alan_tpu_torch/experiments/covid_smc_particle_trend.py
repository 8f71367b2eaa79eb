"""SMC against the NUTS gold by particle count (the port's counterpart of
``scripts/covid_smc_particle_trend.py``).

    python -m alan_tpu_torch.experiments.covid_smc_particle_trend [256 1024 4096] [--device cpu]

The same SMC as ``covid_k_sweep`` (same posterior, the cached gold, a
generator seeded ``seed + 5``) at each particle count, every count against
the one cached gold.  A z falling with the count says SMC converges toward
the NUTS gold.  Merges ``particle_trend`` (a count already there is kept)
and ``particle_trend_note`` into the ``moments_vs_smc_covid.json`` that
``covid_k_sweep`` wrote in the same output directory.
"""
from __future__ import annotations

import os
import time

import torch

from ..utils import resolve_device, seeded_generator
from . import covid_recipe as cr


def run(nRs=16, nDs=25, particle_counts=(256, 1024, 4096), seed=0, draws=500, warmup=500,
        chains=4, max_depth=8, device="cuda", out_dir=cr.RESULTS):
    from ..models import covid
    from ..smc import run_smc
    device = resolve_device(device)
    gold, dims, _, _ = cr.load_or_run_gold(nRs, nDs, draws, warmup, chains, seed, max_depth,
                                           out_dir, device)
    path = cr.record_path(out_dir, "moments_vs_smc_covid.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: run covid_k_sweep with this --out-dir first")
    rec = cr.read_json(path)
    trend = rec.setdefault("particle_trend", {})
    ps, cov, data, _ = cr.recipe(nRs, nDs, seed, device)
    P = covid.get_P(ps, cov, device=device)
    for n in particle_counts:
        if str(n) in trend:
            print(f"particles={n}: cached", flush=True)
            continue
        cr.sync(device)
        t0 = time.perf_counter()
        samples, info = run_smc(P, data, num_particles=n,
                                generator=seeded_generator(seed + 5, device))
        cr.sync(device)
        dt = time.perf_counter() - t0
        draws_ = {k: v.with_dims_front(["particle", *dims[k]]).data.cpu().numpy()
                  for k, v in samples.items() if k in dims}
        st = cr.zstats(draws_, gold)
        st.update(log_Z=float(info["log_Z"]), stages=int(info["stages"]), smc_time_s=dt,
                  host_syncs=info["host_syncs"],
                  finite=bool(torch.isfinite(info["theta"]).all()))
        trend[str(n)] = st
        print(f"particles={n}: z_median={st['z_median']:.2f} "
              f"frac<5={st['frac_z_lt_5']:.3f} logZ={st['log_Z']:.1f} ({dt:.1f}s)",
              flush=True)
        cr.write_json(path, rec)            # saved after each count
    ordered = sorted(trend, key=int)
    rec["particle_trend_note"] = (
        "SMC-vs-NUTS overall z by particle count (same posterior, same cached NUTS gold, "
        "generator seed+5): " + ", ".join(f"{n}: {trend[n]['z_median']:.1f}" for n in ordered))
    cr.write_json(path, rec)
    print(rec["particle_trend_note"])
    return rec


def main(argv=None):
    ap = cr.parser(__doc__)
    ap.add_argument("counts", type=int, nargs="*", default=[256, 1024, 4096])
    cr.gold_args(ap)
    a = ap.parse_args(argv)
    return run(a.nRs, a.nDs, tuple(a.counts), a.seed, a.draws, a.warmup,
               max_depth=a.max_depth, device=a.device, out_dir=a.out_dir)


if __name__ == "__main__":
    main()
