"""The latent-recovery gates of ``tests/test_latent_recovery.py`` as
functions a card runs, each returning a record with its measured values
and ``ok``.

    python -m alan_tpu_torch.experiments.latent_recovery [--models radon covid] [--device cpu]

Fake data drawn with its generating latents (``return_fake_latents``)
lets QEM be held to ground truth: for data drawn from the prior an exact
posterior is calibrated, so at least 85% of the continuous latent
coordinates (70% for occupancy) must lie within 5 posterior sd of their
generating values after training at :data:`MODELS`' settings (covid at
24 x 48 is held to a rising ELBO and finite moments only).  The checks:

- :func:`qem_recovers_generating_latents` (``:105-146``): the ELBO finite
  and its last 10 steps' mean above its first 10's, the coverage
  (occupancy's on the JAX test's own data, :data:`OCCUPANCY_JAX_TEST_DATA`,
  with the port's fake data's beside it);
- :func:`occupancy_discrete_z_qem` (``:149-211``): occupancy's discrete
  ``z`` posterior discriminates the generating state (mean p above 0.5
  apart), Brier score below 0.1, the predictive log-likelihood not more
  than 450 nats below the untrained Q's, and 0.05 mean |dp| across
  training seeds;
- :func:`training_improves_predictive_ll` (``:214-227``): training raises
  MovieLens's and bus_breakdown's predictive log-likelihood;
- :func:`double_timeseries_extend_predictive` (``:230-``): two chains in
  one plate extended from 4 to 7 steps, a finite predictive
  log-likelihood.

Generators are seeded as the JAX test seeds its keys.  Writes
``latent_recovery.json``.
"""
from __future__ import annotations

import importlib
import json
import os
import time

import numpy as np

from ..utils import resolve_device, seeded_generator
from . import covid_recipe as cr
from .occupancy_collapse_probe import coverage_arrays, coverage_of

#: ``tests/test_latent_recovery.py:34-66``
MODELS = {
    "movielens": dict(K=30, iters=120, lr=0.1, skip=()),
    "bus_breakdown": dict(K=30, iters=150, lr=0.1, skip=()),
    "chimpanzees": dict(K=30, iters=150, lr=0.1, skip=()),
    "occupancy": dict(K=15, iters=150, lr="0.03/t@60", skip=("z",), min_coverage=0.7),
    "radon": dict(K=30, iters=120, lr=0.1, skip=()),
    "covid": dict(K=15, iters=30, lr=0.01, skip=(), small=dict(nRs=24, nDs=48),
                  coverage=False),
}
#: the K of the predictive log-likelihood (``:69``)
K = 30
#: the JAX test's own occupancy data: ``alan_tpu``'s fake data at
#: ``jax.random.key(0)`` and their latents, saved as numpy by
#: ``tests/occupancy_fixture.py``.  The 0.70 bar was set on these data; the
#: port's own fake data (numpy seed 0) are another draw, on which QEM covers
#: less whichever package fits them
OCCUPANCY_JAX_TEST_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                                       "occupancy_jax_key0.npz")


def occupancy_jax_test_data(device="cuda"):
    """(problem, None, None, None, latents) on :data:`OCCUPANCY_JAX_TEST_DATA`."""
    from ..convert import dt_from_numpy
    from ..models import occupancy
    z = np.load(OCCUPANCY_JAX_TEST_DATA)
    dims = json.loads(str(z["dims"]))
    dt = lambda k: dt_from_numpy(z[k], dims[k], device)
    ps = {"plate_Years": occupancy.M, "plate_Birds": occupancy.J, "plate_Ids": occupancy.I,
          "plate_Replicate": occupancy.Returns}
    problem = occupancy.generate_problem(ps, {"obs": dt("obs")},
                                         {k: dt(k) for k in ("weather", "quality")}, "qem",
                                         device=device)
    return problem, None, None, None, {k: dt(k) for k in dims
                                       if k not in ("obs", "weather", "quality")}


def _load(name, seed=0, device="cuda", data="port"):
    """(problem, all_data, all_covariates, all_platesizes, latents) on the
    port's fake data, or with ``data="jax_test"`` occupancy on the JAX
    test's."""
    if data == "jax_test":
        assert name == "occupancy"
        return occupancy_jax_test_data(device)
    mod = importlib.import_module(f"alan_tpu_torch.models.{name}")
    small = MODELS[name].get("small")
    if small:
        out = mod.load_data_covariates(seed=seed, return_fake_latents=True, device=device,
                                       **small)
        ps, all_ps, data, all_data, cov, all_cov, lat = out
        return mod.generate_problem(ps, data, cov, "qem", device=device), all_data, \
            all_cov, all_ps, lat
    return mod.load_and_generate_problem(seed=seed, Q_param_type="qem",
                                         return_fake_latents=True, device=device)


def _train_qem(problem, iters, K_, lr=0.1, seed=1, device="cuda"):
    """QEM for ``iters`` eager steps (a generator seeded ``seed``), the
    state written back; the ELBOs as numpy."""
    from .. import train
    elbos = train.fit(problem, method="qem", K=K_, iters=iters, lr=lr,
                      generator=seeded_generator(seed, device), device=device)
    return elbos.detach().cpu().numpy()


def _elbo_checks(elbos):
    return {"elbo_first10_mean": float(elbos[:10].mean()),
            "elbo_last10_mean": float(elbos[-10:].mean()),
            "elbo_finite": bool(np.isfinite(elbos[-1])),
            "elbo_rising": bool(elbos[-10:].mean() > elbos[:10].mean())}


def _settings(name, K_=None, iters=None):
    cfg = MODELS[name]
    return K_ or cfg["K"], iters or cfg["iters"], cfg["lr"]


def qem_recovers_generating_latents(name, device="cuda", K_=None, iters=None, data="port"):
    cfg = MODELS[name]
    k, n, lr = _settings(name, K_, iters)
    problem, _, _, _, latents = _load(name, device=device, data=data)
    t0 = time.perf_counter()
    elbos = _train_qem(problem, n, k, lr=lr, device=device)
    s = problem.sample(k, seeded_generator(2, device), reparam=False)
    arrays = coverage_arrays(problem, latents, s.marginals(), skip=cfg["skip"])
    cov, per_var, med_sd = coverage_of(arrays)
    rec = {"K": k, "iters": n, "lr": str(lr), **_elbo_checks(elbos),
           "moments_finite": all(bool(np.all(np.isfinite(z))) for z, _ in arrays.values()),
           "coverage": cov, "per_var": per_var, "median_post_sd": med_sd,
           "coverage_checked": cfg.get("coverage", True),
           "min_coverage": cfg.get("min_coverage", 0.85)}
    cr.sync(device)
    rec["seconds"] = time.perf_counter() - t0
    rec["ok"] = (rec["elbo_finite"] and rec["elbo_rising"] and rec["moments_finite"]
                 and (not rec["coverage_checked"] or cov >= rec["min_coverage"]))
    return rec


def occupancy_discrete_z_qem(device="cuda", K_=None, iters=None):
    from ..dims import as_dt, dims_of, slice_dim
    from ..moments import mean
    from ..predict import predictive_ll_fn
    k, n, lr = _settings("occupancy", K_, iters)
    problem, all_data, all_cov, all_ps, latents = _load("occupancy", device=device)
    t0 = time.perf_counter()
    f = predictive_ll_fn(problem, K=k, N=100, extended_platesizes=all_ps)

    def pll(nkeys=3):
        return float(np.mean([float(f(problem.P.state(), problem.Q.state(), all_cov,
                                      all_data, seeded_generator(100 + i, device))["obs"])
                              for i in range(nkeys)]))

    def z_probs(prob):
        s = prob.sample(k, seeded_generator(2, device), reparam=False)
        return as_dt(s.marginals().moments(("z",), mean))

    pll0 = pll()
    elbos = _train_qem(problem, n, k, lr=lr, device=device)
    pll1 = pll()
    phat = z_probs(problem)
    true = as_dt(latents["z"])
    for d in dims_of(true):
        ts = problem.all_platedims[d]
        if true.dim_size(d) > ts:
            true = slice_dim(true, d, 0, ts)
    t = true.with_dims_front(phat.dims).order(*phat.dims).data.cpu().numpy()
    p = phat.order(*phat.dims).data.cpu().numpy()
    problem2 = _load("occupancy", device=device)[0]
    _train_qem(problem2, n, k, lr=lr, seed=7, device=device)
    phat2 = z_probs(problem2)
    p2 = phat2.with_dims_front(phat.dims).order(*phat.dims).data.cpu().numpy()
    rec = {"K": k, "iters": n, "lr": str(lr), **_elbo_checks(elbos),
           "pll_untrained": pll0, "pll_trained": pll1,
           "p_mean_where_z1": float(p[t == 1].mean()),
           "p_mean_where_z0": float(p[t == 0].mean()),
           "brier": float(np.mean((p - t) ** 2)),
           "cross_seed_mean_abs_dp": float(np.abs(p - p2).mean()),
           "p_finite": bool(np.all(np.isfinite(p)))}
    cr.sync(device)
    rec["seconds"] = time.perf_counter() - t0
    rec["ok"] = (rec["elbo_finite"] and rec["elbo_rising"] and np.isfinite(pll1)
                 and pll1 > pll0 - 450.0 and rec["p_finite"]
                 and rec["p_mean_where_z1"] - rec["p_mean_where_z0"] > 0.5
                 and rec["brier"] < 0.1 and rec["cross_seed_mean_abs_dp"] < 0.05)
    return rec


def training_improves_predictive_ll(name, device="cuda", K_=None, iters=None):
    from ..predict import predictive_ll_fn
    k, n, lr = _settings(name, K_, iters)
    problem, all_data, all_cov, all_ps, _ = _load(name, device=device)
    t0 = time.perf_counter()
    f = predictive_ll_fn(problem, K=K_ or K, N=100, extended_platesizes=all_ps)
    pll0 = f(problem.P.state(), problem.Q.state(), all_cov, all_data, seeded_generator(3, device))
    _train_qem(problem, n, k, lr=lr, device=device)
    pll1 = f(problem.P.state(), problem.Q.state(), all_cov, all_data, seeded_generator(3, device))
    rec = {"K": k, "iters": n, "lr": str(lr),
           "pll_untrained": {v: float(x) for v, x in pll0.items()},
           "pll_trained": {v: float(x) for v, x in pll1.items()}}
    cr.sync(device)
    rec["seconds"] = time.perf_counter() - t0
    rec["ok"] = all(rec["pll_trained"][v] > rec["pll_untrained"][v] for v in pll0)
    return rec


def double_timeseries_extend_predictive(device="cuda"):
    from .. import BoundPlate, Data, Normal, Plate, Problem, Timeseries
    from ..convert import dt_from_numpy
    P = Plate(
        init1=Normal(0., 1.), init2=Normal(0., 1.),
        T=Plate(
            ts1=Timeseries("init1", Normal(lambda prev: 0.9 * prev, 0.4)),
            ts2=Timeseries("init2", Normal(lambda prev: 0.5 * prev, 0.4)),
            obs=Normal(lambda ts1, ts2: ts1 + ts2, 1.0),
        ),
    )
    Q = Plate(
        init1=Normal(0., 1.), init2=Normal(0., 1.),
        T=Plate(ts1=Normal(0., 1.), ts2=Normal(0., 1.), obs=Data()),
    )
    rng = np.random.default_rng(0)
    prob = Problem(BoundPlate(P, {"T": 4}, device=device), BoundPlate(Q, {"T": 4}, device=device),
                   {"obs": dt_from_numpy(rng.standard_normal(4).astype(np.float32), ("T",),
                                         device)}, device=device)
    s = prob.sample(16, seeded_generator(0, device))
    isamp = s.importance_sample(50, seeded_generator(1, device))
    ext = isamp.extend({"T": 7}, None, seeded_generator(2, device))
    all_data = {"obs": dt_from_numpy(rng.standard_normal(7).astype(np.float32), ("T",),
                                     device)}
    pll = float(ext.predictive_ll(all_data)["obs"].data)
    d = ext.dump()
    rec = {"predictive_ll": pll, "ts1_T": d["ts1"].dim_size("T"),
           "ts2_T": d["ts2"].dim_size("T")}
    rec["ok"] = bool(np.isfinite(pll)) and rec["ts1_T"] == 7 and rec["ts2_T"] == 7
    return rec


def run(models=tuple(MODELS), K_=None, iters=None, device="cuda", out_dir=cr.RESULTS):
    """Every check over ``models`` (the predictive-LL check over MovieLens
    and bus_breakdown where named; the occupancy check where occupancy
    is); ``K_`` and ``iters`` replace each model's own where given."""
    device = resolve_device(device)
    out = {"K_override": K_, "iters_override": iters, "device": cr.card(device)}
    recs = {m: qem_recovers_generating_latents(m, device, K_, iters) for m in models}
    if "occupancy" in recs:
        # held on the JAX test's own data; the port's fake data reported
        port = recs["occupancy"]
        recs["occupancy"] = qem_recovers_generating_latents("occupancy", device, K_, iters,
                                                            data="jax_test")
        recs["occupancy"].update(data="the JAX test's (OCCUPANCY_JAX_TEST_DATA)",
                                 port_fake_data=port)
    out["test_qem_recovers_generating_latents"] = recs
    if "occupancy" in models:
        out["test_occupancy_discrete_z_qem"] = occupancy_discrete_z_qem(device, K_, iters)
    out["test_training_improves_predictive_ll"] = {
        m: training_improves_predictive_ll(m, device, K_, iters)
        for m in ("movielens", "bus_breakdown") if m in models}
    out["test_double_timeseries_extend_predictive"] = double_timeseries_extend_predictive(device)
    oks = [r["ok"] for k, v in out.items() if k.startswith("test_")
           for r in (v.values() if "ok" not in v else [v])]
    out["ok"] = all(oks)
    cr.write_json(cr.record_path(out_dir, "latent_recovery.json"), out)
    return out


def main(argv=None):
    ap = cr.parser(__doc__)
    ap.add_argument("--models", nargs="+", choices=list(MODELS), default=list(MODELS))
    ap.add_argument("--K", type=int, default=None, help="K of every model")
    ap.add_argument("--iters", type=int, default=None, help="steps of every model")
    a = ap.parse_args(argv)
    r = run(tuple(a.models), a.K, a.iters, a.device, a.out_dir)
    print("ok:", r["ok"], "->", cr.record_path(a.out_dir, "latent_recovery.json"))
    return r


if __name__ == "__main__":
    main()
