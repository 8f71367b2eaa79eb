"""MovieLens factor model (alan-ppl/alan ``examples/models/movielens/
movielens.py``; MovieLens, Harper & Konstan 2015): M = 300 users x N = 5
films, d_z = 18 latent factors, Bernoulli ratings with logits z . x.

The published ratings are not in the repository, so the data come from
the model's fake-data recipe, frozen here from the port's
``alan_tpu_torch/models/movielens.py`` (``fake_data``), drawn from numpy
seed ``data_seed`` of ``movielens.json``.  ``--seed`` never reaches them.

Q ``factorised``: every latent its own particle index
(``movielens.generate_problem``); ``grouped``: mu_z and psi_z share one
(``movielens.grouped_problem``, ``bench_scaling.py:70-93``), which routes
z's cross-particle density through the lazy low-rank kernels.  QEM takes
QEM parameters, VI opt parameters (a location and a log-scale).  The
plain reference is ``movielens_reference.py`` beside this file.
"""
from __future__ import annotations

import numpy as np

PLATES = ("plate_1", "plate_2")


def make_data(cfg):
    """numpy arrays ``x`` (M, N, d_z) and ``obs`` (M, N), float32."""
    M, N, d_z = cfg["M"], cfg["N"], cfg["d_z"]
    rng = np.random.default_rng(cfg["data_seed"])
    x = rng.standard_normal((M, N, d_z)).astype(np.float32)
    mu_z = rng.standard_normal(d_z).astype(np.float32)
    psi_z = rng.standard_normal(d_z).astype(np.float32)
    z = (mu_z + np.exp(psi_z) * rng.standard_normal((M, d_z))).astype(np.float32)
    logits = np.einsum("mf,mnf->mn", z, x)
    obs = (rng.random(logits.shape) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    return {"x": x, "obs": obs}


def build(cfg, data, traffic, device):
    """The port's MovieLens problem with the traffic's Q."""
    from alan_tpu_torch.convert import dt_from_numpy
    from alan_tpu_torch.models import movielens

    sizes = {"plate_1": cfg["M"], "plate_2": cfg["N"]}
    covariates = {"x": dt_from_numpy(data["x"], PLATES, device)}
    obs = {"obs": dt_from_numpy(data["obs"], PLATES, device)}
    param_type = "qem" if traffic["method"] == "qem" else "opt"
    make = {"factorised": movielens.generate_problem,
            "grouped": movielens.grouped_problem}[traffic["q"]]
    return make(sizes, obs, covariates, param_type, device=device)


def shapes(cfg, traffic):
    """The grouped Q's cross-particle density of z runs through the lazy
    low-rank contraction at (S, P, I, J, F) = (1, M, K, K, 2 d_z)."""
    if traffic["q"] != "grouped":
        return {}
    K = traffic["K"]
    return {"lowrank": {"S": 1, "P": cfg["M"], "I": K, "J": K, "F": 2 * cfg["d_z"]}}


def step_flops(cfg, traffic):
    """Model FLOPs of one training step by the port's analytic convention
    (``perf.analytic_flops``, copied here as arithmetic; forward x 3 for a
    step that takes one gradient).  Grouped: the low-rank contraction,
    2 S P I J F for its product and 4 S P I J for its exponentials.
    Factorised: broadcast sums of n factors, (n + 3) an element.  At the
    cells' shapes these give the port's own count (PERF.md: 68.42 and
    0.1223 GFLOP a step)."""
    K, M, N = traffic["K"], cfg["M"], cfg["N"]
    if traffic["q"] == "grouped":
        S, P, I, J, F = 1, M, K, K, 2 * cfg["d_z"]
        return 3.0 * (2.0 * S * P * I * J * F + 4.0 * S * P * I * J)
    # factorised: the sum over K_z a user of z's factor [K_z, K_mu, K_psi]
    # and its observations' (5 an element), the films' sum (6 an element of
    # [M, N, K_z]) and the global sum over K_mu x K_psi
    plate_1 = 5.0 * M * K * K * K
    plate_2 = 6.0 * M * N * K
    top = 10.0 * K * K
    return 3.0 * (plate_1 + plate_2 + top)


def _f64(x):
    import torch
    return x.detach().to("cpu", torch.float64)


def record(state, traffic):
    """``(leaves, first)`` of a program state: Q's parameters by name as
    float64 host tensors (QEM: loc and scale; VI: loc and log-scale), and
    for VI the first gradient of the ELBO that Adam's state holds after
    one step (its first moment over 1 - beta1; Adam descends the negated
    ELBO)."""
    stateQ = state[1]
    if traffic["method"] == "qem":
        return {k: _f64(v.data) for k, v in stateQ["qem_params"].items()}, None
    opt_state = state[2]
    names = list(stateQ["opt"])
    beta1 = opt_state["param_groups"][0]["betas"][0]
    grads = {name: -_f64(opt_state["state"][i]["exp_avg"]) / (1.0 - beta1)
             for i, name in enumerate(names)}
    return {k: _f64(v.data) for k, v in stateQ["opt"].items()}, grads
