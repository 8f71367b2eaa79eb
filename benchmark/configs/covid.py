"""Covid NPI model (Brauner et al. / Leech et al., as alan-ppl/alan's
``examples/models/covid/covid.py`` and ``examples/config/conf_covid.yaml``
set it): 92 regions x 137 days, the first 109 for training, 11 NPIs,
``log_infected`` a first-order Markov chain over the days per region,
negative-binomial case counts.

The published dataset is not in the repository, so the data come from the
model's fake-data recipe, frozen here from the port's
``alan_tpu_torch/models/covid.py`` (``fake_data``), drawn from numpy seed
``data_seed`` of ``covid.json``.  ``--seed`` never reaches them.

The port trains on this data through its own model code
(``alan_tpu_torch.models.covid.generate_problem``).  The plain reference is
``covid_reference.py`` beside this file.
"""
from __future__ import annotations

import math

import numpy as np

PLATES = ("nRs", "nDs")


def make_data(cfg):
    """numpy arrays over all ``nDs`` days (the recipe draws them all, then
    the model trains on the first ``nDs_train``): covariates ``npis``
    (nRs, nDs, nCMs - 2), ``wearing``, ``mobility`` and counts ``obs``
    (nRs, nDs), float32."""
    nRs, nDs, nCMs = cfg["nRs"], cfg["nDs"], cfg["nCMs"]
    rng = np.random.default_rng(cfg["data_seed"])
    npis = (rng.random((nRs, nDs, nCMs - 2)) < 0.3).astype(np.float32)
    wearing = rng.random((nRs, nDs)).astype(np.float32)
    mobility = rng.random((nRs, nDs)).astype(np.float32)

    cm_alpha = rng.normal(0.0, 1.0, nCMs - 2)
    wearing_alpha = rng.normal(0.0, 0.4)
    mobility_alpha = rng.normal(1.704, 0.44)
    region_r = rng.normal(1.07, 0.2 + 0.4)
    initial_size_log_mean = rng.normal(math.log(1000), 0.5)
    noise_mean = rng.normal(math.log(0.01), 0.25)
    initial_size_log = rng.normal(initial_size_log_mean, 0.5, nRs)
    noise = rng.normal(noise_mean, 0.25, nRs)
    psi = rng.normal(0.0, 1.0, nRs)

    log_infected = np.empty((nRs, nDs))
    prev = initial_size_log
    for t in range(nDs):
        mu = (region_r + npis[:, t] @ cm_alpha + wearing_alpha * wearing[:, t]
              + mobility_alpha * mobility[:, t] + prev)
        prev = rng.normal(mu, np.exp(noise))
        log_infected[:, t] = prev

    r = np.exp(psi)[:, None]
    probs = 1.0 / (r * np.exp(-log_infected) + 1 + 1e-7)
    lam = rng.gamma(np.broadcast_to(r, probs.shape)) * probs / (1.0 - probs)
    obs = rng.poisson(lam).astype(np.float32)
    return {"npis": npis, "wearing": wearing, "mobility": mobility, "obs": obs}


def train_data(cfg, data):
    """The training days of every array."""
    return {k: v[:, :cfg["nDs_train"]] for k, v in data.items()}


def build(cfg, data, traffic, device):
    """The port's covid problem on the training days, Q factorised with QEM
    parameters (``traffic["method"] == "qem"``) or opt parameters."""
    from alan_tpu_torch.convert import dt_from_numpy
    from alan_tpu_torch.models import covid

    train = train_data(cfg, data)
    dt = lambda a: dt_from_numpy(a, PLATES, device)
    covariates = {"ActiveCMs_NPIs": dt(train["npis"]),
                  "ActiveCMs_wearing": dt(train["wearing"]),
                  "ActiveCMs_mobility": dt(train["mobility"])}
    sizes = {"nRs": cfg["nRs"], "nDs": cfg["nDs_train"]}
    param_type = "qem" if traffic["method"] == "qem" else "opt"
    if traffic["q"] != "factorised":
        raise ValueError(f"covid has no Q {traffic['q']!r}")
    return covid.generate_problem(sizes, {"obs": dt(train["obs"])}, covariates,
                                  param_type, device=device)


def shapes(cfg, traffic):
    """The shapes the per-layer readers count work at: the chain of
    ``log_infected`` is nRs * K chains of nDs_train operators of K x K."""
    K = traffic["K"]
    return {"chain": {"batch": cfg["nRs"] * K, "T": cfg["nDs_train"], "K": K}}


def step_flops(cfg, traffic):
    """Model FLOPs of one training step at the cell's shapes, by the
    port's analytic convention (``perf.analytic_flops``, copied here as
    arithmetic): 2mnk a log-space matmul plus 2(ik + kj) + 2ij for its
    shift, exp and log; (n + 3) an element for a broadcast sum of n factors
    and its logsumexp; forward x 3 for a step that takes one gradient."""
    K, nRs, T = traffic["K"], cfg["nRs"], cfg["nDs_train"]
    # the chain: a balanced tree over T, one K x K log-matmul a pair
    products, n = 0, T
    while n != 1:
        products += n // 2
        n = n // 2 + n % 2
    chain = nRs * K * products * (2.0 * K ** 3 + 6.0 * K ** 2)
    # log_infected's transition density against every pair of its parents'
    # particles (K_npis x K_a), in its factored form: two features a day
    lowrank = 2.0 * (nRs * T) * K * (K * K) * 2
    # the broadcast sums: over K_a a region (the chain, the group factor
    # and six moment terms), and over K_npis (twelve moment terms)
    sums = (8 + 3.0) * nRs * K * K + (2 + 12 + 3.0) * K
    return 3.0 * (chain + lowrank + sums)


def _f64(x):
    import torch
    return x.detach().to("cpu", torch.float64)


def record(state, traffic):
    """``(leaves, first)`` of a program state: Q's parameters by name as
    float64 host tensors (loc and scale of every latent; dims as the
    reference lays them out), and the optimizer's first gradient where the
    method keeps one (none for QEM)."""
    stateP, stateQ = state[0], state[1]
    if traffic["method"] != "qem":
        raise ValueError("the covid cells train by QEM")
    leaves = {}
    for name, v in stateQ["qem_params"].items():
        if v.dims not in ((), ("nRs",), ("nRs", "nDs")):
            raise ValueError(f"{name}: unexpected dims {v.dims}")
        leaves[name] = _f64(v.data)
    return leaves, None
