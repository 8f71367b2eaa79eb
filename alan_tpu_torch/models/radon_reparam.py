"""Radon with a badly scaled ``State_mean`` (counterpart of
``examples/models/radon_reparam.py``): divided by SCALE = 1000 in the
prior and multiplied back in the observation mean, so Q must learn a scale
of ~1/SCALE.  The data are radon's (the observation law is unchanged).
"""
from __future__ import annotations

from ..bound import BoundPlate
from ..ir import Normal, Plate
from . import radon as base

SCALE = 1000.0

name = "radon_reparam"

load_data_covariates = base.load_data_covariates


def get_P(platesizes, covariates, device="cuda"):
    P = Plate(
        global_mean=Normal(0., 1.),
        global_log_sigma=Normal(0., 1.),
        States=Plate(
            State_mean=Normal(lambda global_mean: global_mean / SCALE,
                              lambda global_log_sigma: global_log_sigma.exp() / SCALE),
            State_log_sigma=Normal(0., 1.),
            Beta_u=Normal(0., 1.),
            Beta_basement=Normal(0., 1.),
            Zips=Plate(
                obs=Normal(lambda State_mean, basement, log_uranium, Beta_basement, Beta_u:
                           SCALE * State_mean + basement * Beta_basement
                           + log_uranium * Beta_u,
                           lambda State_log_sigma: State_log_sigma.exp()),
            ),
        ),
    )
    return BoundPlate(P, platesizes, inputs=covariates, device=device)


def generate_problem(platesizes, data, covariates, Q_param_type="qem", device="cuda"):
    return base.generate_problem(platesizes, data, covariates, Q_param_type, device,
                                 get_P=get_P, state_mean_scale=1.0 / SCALE)


def load_and_generate_problem(seed=0, Q_param_type="qem", fake_data=True,
                              data_dir="data/", device="cuda"):
    """(problem, all_data, all_covariates, all_platesizes)."""
    ps, all_ps, data, all_data, cov, all_cov = load_data_covariates(
        seed, fake_data, data_dir, device)
    return generate_problem(ps, data, cov, Q_param_type, device), all_data, all_cov, all_ps
