"""MovieLens with a badly scaled per-user factor (counterpart of
``examples/models/movielens_reparam.py``): ``z`` is divided by SCALE = 100
in the prior and multiplied back in the logits, so a good Q must learn a
scale of ~1/SCALE; the QEM paper's test of how sensitive the methods are
to the parameterisation.  300 users x 5 films (10 over the extended
plate), d_z = 18.

The data are movielens's (the observation law is unchanged): its numpy
fake data, the held-out films drawn after the rest, or with
``fake_data=False`` the reference's ``weights_{N}_{M}`` and
``data_y_{N}_{M}`` train/test files from ``data_dir``.
"""
from __future__ import annotations

import math

import torch

from ..bound import BoundPlate
from ..ir import Bernoulli, Data, Normal, OptParam, Plate, QEMParam
from ..problem import Problem
from . import movielens as base

d_z = base.d_z
M, N = base.M, base.N
SCALE = 100.0

name = "movielens_reparam"


def load_data_covariates(seed=0, fake_data=True, data_dir="data/", M=M, N=N,
                         device="cuda"):
    """(platesizes, all_platesizes, data, all_data, covariates,
    all_covariates) on ``device``: N training films and N held out."""
    return base.load_train_all(seed, fake_data, data_dir, M, N, device=device)


def get_P(platesizes, covariates, device="cuda"):
    P = Plate(
        mu_z=Normal(torch.zeros(d_z), torch.ones(d_z)),
        psi_z=Normal(torch.zeros(d_z), torch.ones(d_z)),
        plate_1=Plate(
            z=Normal(lambda mu_z: mu_z / SCALE, lambda psi_z: psi_z.exp() / SCALE),
            plate_2=Plate(obs=Bernoulli(logits=lambda z, x: (SCALE * z) @ x)),
        ),
    )
    return BoundPlate(P, platesizes, inputs=covariates, device=device)


def generate_problem(platesizes, data, covariates, Q_param_type="qem", device="cuda"):
    P = get_P(platesizes, covariates, device)

    def ls(scale_init=1.0):
        if Q_param_type == "opt":
            return (OptParam(torch.zeros(d_z)),
                    OptParam(torch.full((d_z,), math.log(scale_init)),
                             transformation=torch.exp))
        if Q_param_type != "qem":
            raise ValueError(f"Q_param_type must be 'qem' or 'opt', not {Q_param_type!r}")
        return (QEMParam(torch.zeros(d_z)), QEMParam(torch.full((d_z,), scale_init)))

    Q = Plate(
        mu_z=Normal(*ls()),
        psi_z=Normal(*ls()),
        plate_1=Plate(z=Normal(*ls(1.0 / SCALE)), plate_2=Plate(obs=Data())),
    )
    Q = BoundPlate(Q, platesizes, inputs=covariates, device=device)
    return Problem(P, Q, data, device=device)


def load_and_generate_problem(seed=0, Q_param_type="qem", fake_data=True,
                              data_dir="data/", device="cuda"):
    """(problem, all_data, all_covariates, all_platesizes)."""
    ps, all_ps, data, all_data, cov, all_cov = load_data_covariates(
        seed, fake_data, data_dir, device=device)
    return generate_problem(ps, data, cov, Q_param_type, device), all_data, all_cov, all_ps
