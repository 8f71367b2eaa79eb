"""Radon hierarchical linear regression (counterpart of
``examples/models/radon.py``; Gelman et al. 2006): 4 States x 100 Zips,
the first 50 Zips for training, the log-radon level of a house Normal
about its State's mean plus the basement and log-uranium covariates.

Fake data comes from a numpy seed at those shapes: ``basement`` ~
Bernoulli(0.5), ``log_uranium`` ~ N(0, 1), every latent from the prior,
then the observations.  ``fake_data=False`` reads ``log_radon``,
``basement`` and ``log_u`` from ``data_dir`` (the reference's file names;
the plate sizes come from the arrays, training on the first half of the
Zips).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..bound import BoundPlate
from ..ir import Data, Group, Normal, OptParam, Plate, QEMParam
from ..problem import Problem
from ._realdata import check_fake, fake_latents, load_array, split_dts

n_states, n_zips = 4, 100
_DIMS = ("States", "Zips")

name = "radon"


def fake_arrays(seed=0):
    """numpy covariates ``basement``, ``log_uranium`` and ``obs`` (States,
    Zips) over all 100 Zips, and the latents they were drawn from."""
    rng = np.random.default_rng(seed)
    basement = (rng.random((n_states, n_zips)) < 0.5).astype(np.float32)
    log_u = rng.standard_normal((n_states, n_zips)).astype(np.float32)
    lat = {"global_mean": rng.normal(), "global_log_sigma": rng.normal()}
    lat["State_mean"] = rng.normal(lat["global_mean"], math.exp(lat["global_log_sigma"]),
                                   n_states)
    for k in ("State_log_sigma", "Beta_u", "Beta_basement"):
        lat[k] = rng.normal(0.0, 1.0, n_states)
    loc = (lat["State_mean"][:, None] + basement * lat["Beta_basement"][:, None]
           + log_u * lat["Beta_u"][:, None])
    obs = rng.normal(loc, np.exp(lat["State_log_sigma"])[:, None])
    out = {"basement": basement, "log_uranium": log_u, "obs": obs.astype(np.float32)}
    out.update({k: np.asarray(v, np.float32) for k, v in lat.items()})
    return out


def load_data_covariates(seed=0, fake_data=True, data_dir="data/", device="cuda",
                         return_fake_latents=False):
    """(platesizes, all_platesizes, data, all_data, covariates,
    all_covariates) on ``device``, and with ``return_fake_latents`` the
    latents the fake data were drawn from (``_realdata.fake_latents``)."""
    check_fake(fake_data, return_fake_latents)
    if fake_data:
        a = fake_arrays(seed)
        cov = {"basement": a["basement"], "log_uranium": a["log_uranium"]}
        obs = a["obs"]
    else:
        cov = {"basement": load_array(data_dir, "basement"),
               "log_uranium": load_array(data_dir, "log_u")}
        obs = load_array(data_dir, "log_radon")
    S, Z = obs.shape
    covariates, all_covariates = split_dts(cov, _DIMS, 1, Z // 2, device)
    data, all_data = split_dts({"obs": obs}, _DIMS, 1, Z // 2, device)
    out = ({"States": S, "Zips": Z // 2}, {"States": S, "Zips": Z},
           data, all_data, covariates, all_covariates)
    if return_fake_latents:
        out += (fake_latents(get_P(out[1], out[5], device), a, all_data, _DIMS,
                             device),)
    return out


def get_P(platesizes, covariates, device="cuda"):
    P = Plate(
        global_mean=Normal(0., 1.),
        global_log_sigma=Normal(0., 1.),
        States=Plate(
            State_mean=Normal("global_mean", lambda global_log_sigma: global_log_sigma.exp()),
            State_log_sigma=Normal(0., 1.),
            Beta_u=Normal(0., 1.),
            Beta_basement=Normal(0., 1.),
            Zips=Plate(
                obs=Normal(lambda State_mean, basement, log_uranium, Beta_basement, Beta_u:
                           State_mean + basement * Beta_basement + log_uranium * Beta_u,
                           lambda State_log_sigma: State_log_sigma.exp()),
            ),
        ),
    )
    return BoundPlate(P, platesizes, inputs=covariates, device=device)


def loc_scale(Q_param_type, scale_init=1.0):
    """The (loc, scale) parameters of a Normal in Q: QEM parameters, or opt
    params (a location and a log-scale)."""
    if Q_param_type == "opt":
        return (OptParam(0.), OptParam(math.log(scale_init), transformation=torch.exp))
    if Q_param_type != "qem":
        raise ValueError(f"Q_param_type must be 'qem' or 'opt', not {Q_param_type!r}")
    return (QEMParam(0.), QEMParam(scale_init))


def generate_problem(platesizes, data, covariates, Q_param_type="qem", device="cuda",
                     get_P=get_P, state_mean_scale=1.0):
    """Radon with a factorised Normal Q; ``get_P`` and the initial scale of
    State_mean's proposal are radon_reparam's hooks."""
    P = get_P(platesizes, covariates, device)
    ls = lambda scale=1.0: loc_scale(Q_param_type, scale)
    Q = Plate(
        global_latents=Group(
            global_mean=Normal(*ls()),
            global_log_sigma=Normal(*ls()),
        ),
        States=Plate(
            State_mean=Normal(*ls(state_mean_scale)),
            State_log_sigma=Normal(*ls()),
            Beta_u=Normal(*ls()),
            Beta_basement=Normal(*ls()),
            Zips=Plate(obs=Data()),
        ),
    )
    Q = BoundPlate(Q, platesizes, inputs=covariates, device=device)
    return Problem(P, Q, data, device=device)


def load_and_generate_problem(seed=0, Q_param_type="qem", fake_data=True,
                              data_dir="data/", return_fake_latents=False, device="cuda"):
    """(problem, all_data, all_covariates, all_platesizes), and with
    ``return_fake_latents`` the latents the fake data were drawn from."""
    out = load_data_covariates(seed, fake_data, data_dir, device,
                               return_fake_latents=return_fake_latents)
    ps, all_ps, data, all_data, cov, all_cov = out[:6]
    problem = generate_problem(ps, data, cov, Q_param_type, device)
    return (problem, all_data, all_cov, all_ps, *out[6:])
