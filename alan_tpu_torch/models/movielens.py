"""MovieLens factor model (counterpart of ``examples/models/movielens.py``
and of ``_grouped_movielens`` in ``bench_scaling.py:70-93``): M=300 users x
N=5 films, d_z=18 latent factors, Bernoulli observations with logits z . x.

Fake data comes from a numpy seed (:func:`fake_data`), so the same arrays
can feed this package and ``alan_tpu``: covariates ``x ~ N(0, 1)``, latents
from the prior, ``obs ~ Bernoulli(sigmoid(z . x))``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..bound import BoundPlate
from ..convert import dt_from_numpy
from ..ir import Bernoulli, Data, Group, Normal, Plate, QEMParam
from ..problem import Problem

d_z = 18
M, N = 300, 5


def fake_data(seed=0, M=M, N=N):
    """numpy arrays ``x`` (M, N, d_z), ``obs`` (M, N) and the latents
    ``mu_z``, ``psi_z`` (d_z,) and ``z`` (M, d_z) they were drawn from."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, N, d_z)).astype(np.float32)
    mu_z = rng.standard_normal(d_z).astype(np.float32)
    psi_z = rng.standard_normal(d_z).astype(np.float32)
    z = (mu_z + np.exp(psi_z) * rng.standard_normal((M, d_z))).astype(np.float32)
    logits = np.einsum("mf,mnf->mn", z, x)
    obs = (rng.random((M, N)) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    return {"x": x, "obs": obs, "mu_z": mu_z, "psi_z": psi_z, "z": z}


def load_data_covariates(seed=0, M=M, N=N, device="cuda"):
    """(platesizes, data, covariates) of a fake dataset, on ``device``."""
    arrays = fake_data(seed, M, N)
    plates = ("plate_1", "plate_2")
    covariates = {"x": dt_from_numpy(arrays["x"], plates, device)}
    data = {"obs": dt_from_numpy(arrays["obs"], plates, device)}
    return {"plate_1": M, "plate_2": N}, data, covariates


def get_P(platesizes, covariates, device="cuda"):
    P = Plate(
        mu_z=Normal(torch.zeros(d_z), torch.ones(d_z)),
        psi_z=Normal(torch.zeros(d_z), torch.ones(d_z)),
        plate_1=Plate(
            z=Normal("mu_z", lambda psi_z: psi_z.exp()),
            plate_2=Plate(
                obs=Bernoulli(logits=lambda z, x: z @ x),
            ),
        ),
    )
    return BoundPlate(P, platesizes, inputs=covariates, device=device)


def _qem_normal():
    return Normal(QEMParam(torch.zeros(d_z)), QEMParam(torch.ones(d_z)))


def generate_problem(platesizes, data, covariates, device="cuda"):
    """MovieLens with a QEM Q: every latent has its own K-dim."""
    P = get_P(platesizes, covariates, device)
    Q = Plate(
        mu_z=_qem_normal(),
        psi_z=_qem_normal(),
        plate_1=Plate(z=_qem_normal(), plate_2=Plate(obs=Data())),
    )
    Q = BoundPlate(Q, platesizes, inputs=covariates, device=device)
    return Problem(P, Q, data, device=device)


def grouped_problem(platesizes, data, covariates, device="cuda"):
    """MovieLens with mu_z and psi_z grouped onto one K-dim: the z factor
    shrinks from K^3 x plate to K^2 x plate, which is what makes K=1000
    feasible, and routes z's cross-K factor through the lazy contraction."""
    P = get_P(platesizes, covariates, device)
    Q = Plate(
        g=Group(mu_z=_qem_normal(), psi_z=_qem_normal()),
        plate_1=Plate(z=_qem_normal(), plate_2=Plate(obs=Data())),
    )
    Q = BoundPlate(Q, platesizes, inputs=covariates, device=device)
    return Problem(P, Q, data, device=device)
