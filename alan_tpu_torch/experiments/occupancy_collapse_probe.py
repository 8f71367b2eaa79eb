"""Occupancy's coverage of its generating latents under seven training
configurations (the port's counterpart of
``scripts/occupancy_collapse_probe.py``).

    python -m alan_tpu_torch.experiments.occupancy_collapse_probe [--device cpu]

Occupancy on its fake data (seed 0) with its generating latents.  Each
configuration trains from fresh parameters (a generator seeded 1), then
reads the marginals of a K-particle sample (seeded 2): the coverage (the
share of continuous latent coordinates within 5 posterior sd of the
generating value; the discrete ``z`` left out), each latent's coverage,
the median posterior sd (the collapse observable) and the mean ELBO of the
last 10 steps.  The configurations: QEM at a fixed lr of 0.03 after 60 and
150 steps, QEM under the delayed schedule ``"0.03/t@60"`` after 150 and
300, QEM at K = 30 under ``"0.1/t@60"``, and RWS (the opt Q) after 150 and
300 at lr 0.01.  Writes ``occupancy_collapse_probe.json``.
"""
from __future__ import annotations

import json

import numpy as np

from ..utils import resolve_device, seeded_generator
from . import covid_recipe as cr

SKIP = ("z",)          # discrete Bernoulli state: residual/sd meaningless

#: name: (method, Q_param_type, K, iters, lr), ``occupancy_collapse_probe.py:85-109``
CONFIGS = {
    "qem_fixed_it60": ("qem", "qem", 15, 60, 0.03),
    "qem_fixed_it150": ("qem", "qem", 15, 150, 0.03),
    "qem_sched_it150": ("qem", "qem", 15, 150, "0.03/t@60"),
    "qem_sched_it300": ("qem", "qem", 15, 300, "0.03/t@60"),
    "qem_K30_sched_it150": ("qem", "qem", 30, 150, "0.1/t@60"),
    "rws_it150": ("rws", "opt", 15, 150, 0.01),
    "rws_it300": ("rws", "opt", 15, 300, 0.01),
}


def load(qtype, seed=0, device="cuda"):
    from ..models import occupancy
    return occupancy.load_and_generate_problem(seed=seed, Q_param_type=qtype,
                                               return_fake_latents=True, device=device)


def coverage_arrays(problem, latents, marg, skip=SKIP):
    """``{name: (|generating value - mean| / sd, sd)}`` of each latent not in
    ``skip``, its generating values cut to the training plates
    (``occupancy_collapse_probe.py:46-73``)."""
    from ..dims import as_dt, dims_of, slice_dim
    from ..moments import mean, mean2
    out = {}
    for vn, true in latents.items():
        if vn in skip:
            continue
        true = as_dt(true)
        for d in dims_of(true):
            train_size = problem.all_platedims[d]
            if true.dim_size(d) > train_size:
                true = slice_dim(true, d, 0, train_size)
        m1 = as_dt(marg.moments((vn,), mean))
        m2 = as_dt(marg.moments((vn,), mean2))
        post_var = m2 - m1 * m1
        t = true.with_dims_front(m1.dims).order(*m1.dims).data.detach().cpu().numpy()
        mu = m1.order(*m1.dims).data.detach().cpu().numpy()
        sd = np.sqrt(np.clip(post_var.order(*m1.dims).data.detach().cpu().numpy(),
                             1e-12, None))
        out[vn] = (np.abs((t - mu) / sd), sd)
    return out


def coverage_of(arrays):
    """(coverage, {name: coverage}, median sd) of :func:`coverage_arrays`."""
    n_total = sum(z.size for z, _ in arrays.values())
    n_cover = sum(int(np.sum(z < 5.0)) for z, _ in arrays.values())
    per_var = {vn: float(np.mean(z < 5.0)) for vn, (z, _) in arrays.items()}
    sds = np.concatenate([sd.ravel() for _, sd in arrays.values()])
    return n_cover / n_total, per_var, float(np.median(sds))


def coverage(problem, latents, K, generator):
    s = problem.sample(K, generator, reparam=False)
    return coverage_of(coverage_arrays(problem, latents, s.marginals()))


def run_config(name, method, qtype, K, iters, lr, seed=0, device="cuda"):
    import time
    from .. import train
    problem, _, _, _, latents = load(qtype, seed, device)
    t0 = time.perf_counter()
    elbos = train.fit(problem, method=method, K=K, iters=iters, lr=lr,
                      generator=seeded_generator(1, device), device=device)
    elbos = elbos.detach().cpu().numpy()
    cov, per_var, med_sd = coverage(problem, latents, K, seeded_generator(2, device))
    cr.sync(device)
    rec = {"method": method, "K": K, "iters": iters, "lr": str(lr),
           "coverage": round(cov, 4), "median_post_sd": med_sd,
           "elbo_end": float(np.mean(elbos[-10:])), "per_var": per_var,
           "elbos_finite": bool(np.all(np.isfinite(elbos))),
           "seconds": time.perf_counter() - t0}
    print(name, json.dumps({k: rec[k] for k in ("coverage", "median_post_sd", "elbo_end")}),
          flush=True)
    return rec


def run(K=None, iters=None, device="cuda", out_dir=cr.RESULTS):
    """Every configuration of :data:`CONFIGS`, with ``K`` or ``iters`` in
    place of each one's where given."""
    device = resolve_device(device)
    out = {}
    for name, (method, qtype, k, n, lr) in CONFIGS.items():
        out[name] = run_config(name, method, qtype, K or k, iters or n, lr, device=device)
    out["device"] = cr.card(device)
    cr.write_json(cr.record_path(out_dir, "occupancy_collapse_probe.json"), out)
    return out


def main(argv=None):
    ap = cr.parser(__doc__)
    ap.add_argument("--K", type=int, default=None, help="K of every configuration")
    ap.add_argument("--iters", type=int, default=None, help="steps of every configuration")
    a = ap.parse_args(argv)
    r = run(a.K, a.iters, a.device, a.out_dir)
    print("->", cr.record_path(a.out_dir, "occupancy_collapse_probe.json"))
    return r


if __name__ == "__main__":
    main()
