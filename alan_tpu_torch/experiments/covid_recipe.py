"""What the covid experiments share: the realistic-count problem of
``scripts/moments_vs_hmc_covid.py:37-62``, the known-latent full-size
recipe of ``scripts/covid_full_qem_quality.py:70-91``, the z metric of
``scripts/covid_k_sweep.py:75-94, 126-148`` and
``scripts/covid_smc_particle_trend.py:35-56``, and the NUTS gold cache of
``scripts/covid_k_sweep.py:43-72``.

The counts come from ``numpy.random.default_rng(seed + 17)`` as the JAX
scripts draw them, so they are bitwise the JAX scripts' counts.  The
covariates are the port's own fake data (``models/covid.fake_data``), not
the JAX loader's ``jax.random`` draws, so a record compares with the JAX
package's in trend only (:data:`DATA_NOTE`).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..utils import seeded_generator

#: where every experiment writes its records by default
RESULTS = "results_torch"
#: appended to every covid record's ``model`` string
DATA_NOTE = ("same counts as the JAX script (numpy seed + 17), different fake "
             "covariates (models/covid.fake_data): compare with results/ in trend")
#: the reduced covid of the gold comparisons (``moments_vs_hmc_covid.py:142-143``)
REDUCED = (16, 25)


# ---- command lines, devices and records ----------------------------------------

def parser(description):
    """An argument parser with the options every experiment adds to its
    JAX script's: ``--device`` and ``--out-dir``."""
    ap = argparse.ArgumentParser(description=description,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or 'cpu'")
    ap.add_argument("--out-dir", default=RESULTS,
                    help=f"directory of the JSON records (default {RESULTS}/)")
    return ap


def gold_args(ap):
    """The reduced covid and its gold's options, at the JAX scripts'
    defaults (``covid_smc_particle_trend.run``, ``covid_corrq_probe.run``),
    for scripts whose JAX command line does not take them."""
    ap.add_argument("--nRs", type=int, default=REDUCED[0])
    ap.add_argument("--nDs", type=int, default=REDUCED[1])
    ap.add_argument("--draws", type=int, default=500)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card(device):
    """The card's name, or ``"cpu"``."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def record_path(out_dir, name):
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, name)


def write_json(path, rec):
    with open(path, "w") as fh:
        json.dump(rec, fh, indent=1, default=_jsonable)


def read_json(path):
    with open(path) as fh:
        return json.load(fh)


def _jsonable(x):
    if isinstance(x, torch.Tensor):
        return x.tolist()
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return str(x)


# ---- the problems ----------------------------------------------------------------

def recipe(nRs, nDs, seed=0, device="cuda"):
    """Covid's covariates (``models/covid.fake_data``) with counts by the
    recipe of ``scripts/moments_vs_hmc_covid.py:51-62``: log-infected a
    random walk around log(1000) with 0.05 nats a day of drift, counts
    gamma-Poisson at the model's own psi.  (The prior's own counts explode,
    and NUTS's step size collapses on them.)  Returns (platesizes,
    covariates, data, the walk and r = exp(psi))."""
    from ..convert import dt_from_numpy
    from ..models import covid
    ps, _, _, _, cov, _ = covid.load_data_covariates(seed=seed, nRs=nRs, nDs=nDs,
                                                     device=device)
    nT = ps["nDs"]
    rng = np.random.default_rng(seed + 17)
    li = np.log(1000.0) + np.cumsum(rng.normal(0.05, 0.15, size=(nRs, nT)), axis=1)
    r = np.exp(rng.normal(0.0, 1.0, size=(nRs, 1)))
    lam = rng.gamma(shape=r, scale=np.exp(li) / r)
    y = rng.poisson(lam).astype(np.float32)
    return ps, cov, {"obs": dt_from_numpy(y, ("nRs", "nDs"), device)}, (li, r)


def build_problem(nRs, nDs, seed=0, device="cuda", corr_Q=False):
    """The QEM covid problem on :func:`recipe`'s data
    (``moments_vs_hmc_covid.build_problem``; ``corr_Q`` as
    ``covid_corrq_probe.build_corrq``)."""
    from ..models import covid
    ps, cov, data, _ = recipe(nRs, nDs, seed, device)
    return covid.generate_problem(ps, data, cov, "qem", corr_Q=corr_Q, device=device)


def full_size_recipe(seed, device="cuda", nRs=None, nDs=None):
    """``scripts/covid_full_qem_quality.py:70-91``: covid (full size by
    default) with counts from a KNOWN driftless walk around log(1000) (0.15
    nats a day) over all days and a known psi per region.  Returns
    (problem on the training days, all platesizes, all covariates, all
    data, the generating latents over the training days as ``{name:
    (numpy array, dims)}``)."""
    from ..convert import dt_from_numpy
    from ..models import covid
    nRs = covid.nRs if nRs is None else nRs
    nDs = covid.nDs if nDs is None else nDs
    ps, all_ps, _, _, cov, all_cov = covid.load_data_covariates(seed=seed, nRs=nRs,
                                                                nDs=nDs, device=device)
    nRs_, nDs_all, nDs_tr = all_ps["nRs"], all_ps["nDs"], ps["nDs"]
    rng = np.random.default_rng(seed + 17)
    li = np.log(1000.0) + np.cumsum(rng.normal(0.0, 0.15, size=(nRs_, nDs_all)), axis=1)
    psi_true = rng.normal(0.0, 1.0, size=(nRs_,))
    r = np.exp(psi_true)[:, None]
    lam = rng.gamma(shape=r, scale=np.exp(li) / r)
    y = rng.poisson(lam).astype(np.float32)
    all_data = {"obs": dt_from_numpy(y, ("nRs", "nDs"), device)}
    data = {"obs": dt_from_numpy(y[:, :nDs_tr], ("nRs", "nDs"), device)}
    truth = {"log_infected": (li[:, :nDs_tr].astype(np.float32), ("nRs", "nDs")),
             "psi": (psi_true.astype(np.float32), ("nRs",))}
    problem = covid.generate_problem(ps, data, cov, "qem", device=device)
    return problem, dict(all_ps), all_cov, all_data, truth


# ---- the z metric ----------------------------------------------------------------

def gold_mean_stderr(arr):
    """A gold run's mean and standard error per coordinate, from draws laid
    out (draw, chain, ...): the between-chain dispersion of the chain means
    over sqrt(chains), floored at 2% of max(|mean|, 0.05)."""
    arr = np.asarray(arr)
    gm = arr.mean(axis=(0, 1))
    stderr = arr.mean(axis=0).std(axis=0, ddof=1) / np.sqrt(arr.shape[1])
    return gm, np.maximum(stderr, 0.02 * np.maximum(np.abs(gm), 0.05))


def z_table(gold, other):
    """``{name: (other, gold mean, stderr, z)}`` for each name in both whose
    shapes agree (the JAX scripts skip the others); ``other`` maps a name to
    a mean laid out as the gold draws' trailing axes."""
    out = {}
    for name, arr in gold.items():
        if name not in other:
            continue
        gm, stderr = gold_mean_stderr(arr)
        o = np.asarray(other[name])
        if o.shape != gm.shape:
            continue
        out[name] = (o, gm, stderr, np.abs(o - gm) / stderr)
    return out


def variable_stats(o, gm, z):
    """The per-variable entry of ``covid_k_sweep.py:151-154``."""
    return {"mse": float(np.mean((o - gm) ** 2)), "z_median": float(np.median(z)),
            "z_max": float(z.max()), "frac_z_lt_5": float(np.mean(z < 5.0))}


def overall(zs, p90=True):
    """The ``overall`` entry over every coordinate of ``zs`` (a list of z
    arrays), or None for none."""
    if not zs:
        return None
    az = np.concatenate([np.ravel(z) for z in zs])
    out = {"n_coords": int(az.size), "z_median": float(np.median(az))}
    if p90:
        out["z_p90"] = float(np.percentile(az, 90))
    out["frac_z_lt_5"] = float(np.mean(az < 5.0))
    return out


def sweep_entry(gold, other):
    """``{"variables": {name: stats}, "overall": ...}`` of ``other``'s means
    against the gold, as ``covid_k_sweep.py:145-160`` records an MP arm."""
    tab = z_table(gold, other)
    rec = {"variables": {k: variable_stats(o, gm, z) for k, (o, gm, _, z) in tab.items()}}
    ov = overall([z for *_, z in tab.values()])
    if ov is not None:
        rec["overall"] = ov
    return rec


def zstats(samples, gold):
    """``scripts/covid_smc_particle_trend.py:35-56``: particle draws
    ``samples`` (particle, ...) against the gold draws (draw, chain, ...)."""
    means = {k: np.asarray(v).mean(axis=0) for k, v in samples.items()}
    tab = z_table(gold, means)
    ov = overall([z for *_, z in tab.values()], p90=False)
    return {**ov, "variables": {k: {"z_median": float(np.median(z)),
                                    "frac_z_lt_5": float(np.mean(z < 5.0))}
                                for k, (*_, z) in tab.items()}}


def z_scores(gold, other):
    """Every coordinate's z of ``other``'s means against the gold,
    summarised: by variable (median, max), and over all coordinates."""
    tab = z_table(gold, other)
    return {"by_variable": {k: {"z_median": float(np.median(z)), "z_max": float(z.max())}
                            for k, (*_, z) in tab.items()},
            **overall([z for *_, z in tab.values()])}


def draws_np(samples):
    """{name: (draw, chain, ...) numpy} of a sampler's DT draws."""
    return {k: v.with_dims_front(["draw", "chain"]).data.cpu().numpy()
            for k, v in samples.items()}


def dims_of_draws(samples):
    """{name: the plate dims behind a sampler's draw and chain dims}."""
    return {k: tuple(d for d in v.dims if d not in ("draw", "chain", "particle"))
            for k, v in samples.items()}


def gold_diagnostics(gold):
    """Each variable's largest split R-hat and smallest and median bulk ESS
    (``diagnostics``)."""
    from .. import diagnostics
    out = {}
    for name, arr in gold.items():
        rh, es = diagnostics.split_rhat(arr), diagnostics.ess_bulk(arr)
        out[name] = {"rhat_max": float(np.max(rh)), "ess_min": float(np.min(es)),
                     "ess_median": float(np.median(es))}
    return out


# ---- the gold samplers -------------------------------------------------------------

def _moved(theta):
    """The share of (draw, chain) transitions in which a chain moved."""
    if theta.shape[0] < 2:
        return float("nan")
    return float((theta[1:] != theta[:-1]).any(dim=-1).double().mean())


def run_gold(nRs, nDs, seed, sampler="nuts", draws=500, warmup=500, chains=4, max_depth=8,
             key=1, device="cuda"):
    """One gold run on :func:`recipe`'s posterior in the data's float32, as
    the JAX scripts run it, from a generator seeded ``seed + key`` (a prior
    draw as its start, as the JAX scripts start): (draws {name: (draw,
    chain, ...)}, dims, diagnostics, seconds)."""
    from ..mcmc import run_hmc
    from ..models import covid
    from ..nuts import run_nuts
    ps, cov, data, _ = recipe(nRs, nDs, seed, device)
    extra = {"max_depth": max_depth} if sampler == "nuts" else {}
    run = {"nuts": run_nuts, "hmc": run_hmc}[sampler]
    sync(device)
    t0 = time.perf_counter()
    samples, info = run(covid.get_P(ps, cov, device=device), data, num_samples=draws,
                        num_warmup=warmup, num_chains=chains,
                        generator=seeded_generator(seed + key, device), **extra)
    sync(device)
    seconds = time.perf_counter() - t0
    theta = info["theta"]
    diag = {"mean_accept": info["mean_accept"], "step_size": info["step_size"],
            "capture_s": info["capture_s"], "moved_frac": _moved(theta),
            "finite": bool(torch.isfinite(theta).all()),
            "dtype": str(theta.dtype).replace("torch.", "")}
    return draws_np(samples), dims_of_draws(samples), diag, seconds


def load_or_run_gold(nRs, nDs, draws, warmup, chains, seed, max_depth, out_dir,
                     device="cuda"):
    """The NUTS gold of ``covid_k_sweep.py:43-72``, cached in ``out_dir``
    as ``covid_nuts_gold.npz`` beside ``covid_nuts_gold_meta.json``, keyed
    by the JAX script's fields and the plate sizes.  Returns (draws, dims,
    diagnostics, seconds; 0.0 from the cache)."""
    npz = record_path(out_dir, "covid_nuts_gold.npz")
    meta = record_path(out_dir, "covid_nuts_gold_meta.json")
    key = {"draws": draws, "warmup": warmup, "chains": chains, "seed": seed,
           "max_depth": max_depth, "nRs": nRs, "nDs": nDs}
    if os.path.exists(npz) and os.path.exists(meta):
        m = read_json(meta)
        if all(m.get(k) == v for k, v in key.items()):
            z = np.load(npz)
            print("NUTS gold: loaded cache", npz, flush=True)
            return ({k: z[k] for k in z.files}, {k: tuple(v) for k, v in m["dims"].items()},
                    m["diag"], 0.0)
    gold, dims, diag, seconds = run_gold(nRs, nDs, seed, "nuts", draws, warmup, chains,
                                         max_depth, 1, device)
    np.savez(npz, **gold)
    write_json(meta, dict(key, diag=diag, dims=dims, nuts_time_s=seconds))
    return gold, dims, diag, seconds


# ---- MP ----------------------------------------------------------------------------

def fit_mp(problem, K, iters, seed=0, lr="0.1/t@100", computation_strategy=None,
           device="cuda", after_step=None):
    """QEM for ``iters`` eager steps from a generator seeded 0 (the JAX
    ``train.fit``'s default key), written back into the problem, then the
    marginals of a fresh K-particle sample from a generator seeded
    ``seed + 2``.  ``after_step(i)`` runs after step i, and with i = -1
    before the first.  Returns (marginals, ELBOs, seconds)."""
    from .. import train
    from ..split import no_checkpoint
    cs = no_checkpoint if computation_strategy is None else computation_strategy
    sync(device)
    t0 = time.perf_counter()
    step, state = train.qem(problem, K, lr=lr, computation_strategy=cs, device=device)
    gen = seeded_generator(0, device)
    elbos = []
    if after_step is not None:
        after_step(-1)
    for i in range(iters):
        state, e = step(state, gen)
        elbos.append(e)
        if after_step is not None:
            after_step(i)
    if len(state) == 2 and not isinstance(state[1], dict):
        state, _ = state
    problem.P.set_state(state[0])
    problem.Q.set_state(state[1])
    s = problem.sample(K, seeded_generator(seed + 2, device), reparam=False)
    marg = s.marginals(computation_strategy=cs)
    elbos = torch.stack(elbos).tolist() if elbos else []
    sync(device)
    return marg, elbos, time.perf_counter() - t0
