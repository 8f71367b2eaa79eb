"""Bus-breakdown with a badly scaled ``alpha`` (counterpart of
``examples/models/bus_breakdown_reparam.py``): divided by SCALE = 1000 in
the prior and multiplied back in the logits.  The data are
bus_breakdown's (the observation law is unchanged).
"""
from __future__ import annotations

import torch

from ..bound import BoundPlate
from ..ir import Bernoulli, Normal, Plate
from . import bus_breakdown as base

run_type_dim = base.run_type_dim
bus_company_name_dim = base.bus_company_name_dim
SCALE = 1000.0

name = "bus_breakdown_reparam"

load_data_covariates = base.load_data_covariates


def get_P(platesizes, covariates, device="cuda"):
    P = Plate(
        psi=Normal(torch.zeros(run_type_dim), torch.ones(run_type_dim)),
        phi=Normal(torch.zeros(bus_company_name_dim), torch.ones(bus_company_name_dim)),
        sigma_beta=Normal(0, 1),
        mu_beta=Normal(0, 1),
        plate_Year=Plate(
            beta=Normal(lambda mu_beta: mu_beta, lambda sigma_beta: sigma_beta.exp()),
            sigma_alpha=Normal(0, 1),
            plate_Borough=Plate(
                alpha=Normal(lambda beta: beta / SCALE,
                             lambda sigma_alpha: sigma_alpha.exp() / SCALE),
                plate_ID=Plate(
                    obs=Bernoulli(logits=lambda alpha, phi, psi, run_type, bus_company_name:
                                  alpha * SCALE + phi @ bus_company_name + psi @ run_type),
                ),
            ),
        ),
    )
    return BoundPlate(P, platesizes, inputs=covariates, device=device)


def generate_problem(platesizes, data, covariates, Q_param_type="qem", device="cuda"):
    return base.generate_problem(platesizes, data, covariates, Q_param_type, device,
                                 get_P=get_P, alpha_scale=1.0 / SCALE)


def load_and_generate_problem(seed=0, Q_param_type="qem", fake_data=True,
                              data_dir="data/", run=0, device="cuda"):
    """(problem, all_data, all_covariates, all_platesizes)."""
    ps, all_ps, data, all_data, cov, all_cov = load_data_covariates(
        seed, fake_data, data_dir, run, device)
    return generate_problem(ps, data, cov, Q_param_type, device), all_data, all_cov, all_ps
