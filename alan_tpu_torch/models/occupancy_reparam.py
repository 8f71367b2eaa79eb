"""Occupancy with a badly scaled ``bird_year_mean`` (counterpart of
``examples/models/occupancy_reparam.py``): divided by SCALE = 1000 in the
prior and multiplied back in the presence logits.  The data are
occupancy's (the observation law is unchanged).
"""
from __future__ import annotations

from ..bound import BoundPlate
from ..ir import Bernoulli, Normal, Plate
from . import occupancy as base

SCALE = 1000.0

name = "occupancy_reparam"

load_data_covariates = base.load_data_covariates


def get_P(platesizes, covariates, device="cuda"):
    P = Plate(
        bird_mean_mean=Normal(0., 1.),
        bird_mean_log_var=Normal(0., 1.),
        alpha_mean=Normal(0., 1.),
        alpha_log_var=Normal(0., 1.),
        beta_mean=Normal(0., 1.),
        beta_log_var=Normal(0., 1.),
        plate_Birds=Plate(
            bird_mean=Normal("bird_mean_mean", lambda bird_mean_log_var: bird_mean_log_var.exp()),
            alpha=Normal("alpha_mean", lambda alpha_log_var: alpha_log_var.exp()),
            beta=Normal("beta_mean", lambda beta_log_var: beta_log_var.exp()),
            plate_Years=Plate(
                bird_year_mean=Normal(lambda bird_mean: bird_mean / SCALE, 1.0 / SCALE),
                plate_Ids=Plate(
                    z=Bernoulli(logits=lambda weather, bird_year_mean, beta:
                                SCALE * bird_year_mean * weather * beta),
                    plate_Replicate=Plate(
                        obs=Bernoulli(logits=lambda alpha, quality, z:
                                      alpha * quality * z + (1 - z) * (-10)),
                    ),
                ),
            ),
        ),
    )
    return BoundPlate(P, platesizes, inputs=covariates, device=device)


def generate_problem(platesizes, data, covariates, Q_param_type="qem", device="cuda"):
    return base.generate_problem(platesizes, data, covariates, Q_param_type, device,
                                 get_P=get_P, bird_year_mean_scale=1.0 / SCALE)


def load_and_generate_problem(seed=0, Q_param_type="qem", fake_data=True,
                              data_dir="data/", run=0, device="cuda"):
    """(problem, all_data, all_covariates, all_platesizes)."""
    ps, all_ps, data, all_data, cov, all_cov = load_data_covariates(
        seed, fake_data, data_dir, run, device)
    return generate_problem(ps, data, cov, Q_param_type, device), all_data, all_cov, all_ps
