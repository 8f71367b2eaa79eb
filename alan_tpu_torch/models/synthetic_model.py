"""Synthetic Normal-Normal model (counterpart of
``examples/models/synthetic_model.py``): a scalar latent ``mean`` with the
prior N(33, 0.5) and N = 4 observations N(mean, 10) (8 over the extended
plate).  Conjugate, so its posterior is known: :func:`posterior`.

Fake data comes from a numpy seed: ``mean`` from its prior, then the 8
observations.  There is no real dataset (``data_dir`` is accepted for a
uniform interface).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..bound import BoundPlate
from ..convert import dt_from_numpy
from ..ir import Data, Normal, OptParam, Plate, QEMParam
from ..problem import Problem

N = 4
N_extended = 8
z_mean = 33.0
z_var = 0.5
obs_var = 10.0

name = "synthetic_model"


def fake_arrays(seed=0):
    """numpy ``mean`` and ``obs`` (N_extended,)."""
    rng = np.random.default_rng(seed)
    mean = rng.normal(z_mean, z_var)
    obs = rng.normal(mean, obs_var, N_extended).astype(np.float32)
    return {"mean": np.float32(mean), "obs": obs}


def load_data_covariates(seed=0, fake_data=True, data_dir="data/", device="cuda"):
    """(platesizes, all_platesizes, data, all_data, covariates,
    all_covariates); the model has no covariates."""
    arrays = fake_arrays(seed)
    all_obs = dt_from_numpy(arrays["obs"], ("plate_1",), device)
    obs = dt_from_numpy(arrays["obs"][:N], ("plate_1",), device)
    return ({"plate_1": N}, {"plate_1": N_extended}, {"obs": obs}, {"obs": all_obs}, {}, {})


def posterior(obs):
    """(mean, sd) of the exact posterior of ``mean`` given observations
    ``obs`` (numpy)."""
    obs = np.asarray(obs, np.float64)
    prec = 1 / z_var ** 2 + obs.size / obs_var ** 2
    loc = (z_mean / z_var ** 2 + obs.sum() / obs_var ** 2) / prec
    return loc, math.sqrt(1 / prec)


def get_P(platesizes, covariates, device="cuda"):
    P = Plate(
        mean=Normal(z_mean, z_var),
        plate_1=Plate(obs=Normal("mean", obs_var)),
    )
    return BoundPlate(P, platesizes, inputs=covariates, device=device)


def generate_problem(platesizes, data, covariates, Q_param_type="qem", device="cuda"):
    P = get_P(platesizes, covariates, device)
    if Q_param_type == "opt":
        q = Normal(OptParam(0.), OptParam(0., transformation=torch.exp))
    elif Q_param_type == "qem":
        q = Normal(QEMParam(0.), QEMParam(1.))
    else:
        raise ValueError(f"Q_param_type must be 'qem' or 'opt', not {Q_param_type!r}")
    Q = BoundPlate(Plate(mean=q, plate_1=Plate(obs=Data())), platesizes,
                   inputs=covariates, device=device)
    return Problem(P, Q, data, device=device)


def load_and_generate_problem(seed=0, Q_param_type="qem", fake_data=True,
                              data_dir="data/", device="cuda"):
    """(problem, all_data, all_covariates, all_platesizes)."""
    ps, all_ps, data, all_data, cov, all_cov = load_data_covariates(
        seed, fake_data, data_dir, device)
    return generate_problem(ps, data, cov, Q_param_type, device), all_data, all_cov, all_ps
