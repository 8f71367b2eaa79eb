"""Kalman-checkable AR(1) timeseries (counterpart of the test model
``tests/model_timeseries.py``): T = 4 steps of
``ts_t ~ N(0.9 ts_{t-1}, 0.1)`` from ``init ~ N(0, 1)``, observed as
``obs_t ~ N(ts_t, 1)``.  The data are one draw from the exact marginal
(numpy seed 12), and the exact log-likelihood (:data:`known_elbo`) and
posterior mean of ``ts`` (:data:`post_mean`) are Gaussian algebra.

At large K its chain (``[T, K, K]``, no batch) runs through the fused
log-matmul kernel: at K = 1000 one (2, K, K) @ (2, K, K) level and one
(1, K, K) @ (1, K, K) level.
"""
from __future__ import annotations

import numpy as np

from ..bound import BoundPlate
from ..convert import dt_from_numpy
from ..ir import Data, Normal, Plate, Timeseries
from ..problem import Problem

T = 4
A = 0.9
init_scale = 1.
ts_noise_scale = 0.1
obs_noise_scale = 1.


def _moments():
    prior_cov = np.zeros((T, T))
    diag_var = init_scale ** 2
    for i in range(T):
        diag_var = diag_var * A ** 2 + ts_noise_scale ** 2
        future = diag_var * A ** np.arange(T - i)
        prior_cov[i, i:] = future
        prior_cov[i:, i] = future
    full_cov = prior_cov + obs_noise_scale ** 2 * np.eye(T)
    data = np.linalg.cholesky(full_cov) @ np.random.default_rng(12).standard_normal(T)
    _, logdet = np.linalg.slogdet(full_cov)
    loglik = -0.5 * (data @ np.linalg.solve(full_cov, data) + logdet
                     + T * np.log(2 * np.pi))
    like_prec = np.eye(T) / obs_noise_scale ** 2
    post_cov = np.linalg.inv(np.linalg.inv(prior_cov) + like_prec)
    return data, float(loglik), post_cov @ like_prec @ data


data_ts, known_elbo, post_mean = _moments()


def generate_problem(device="cuda"):
    P = Plate(
        init=Normal(0, init_scale),
        T=Plate(
            ts=Timeseries("init", Normal(lambda prev: A * prev, ts_noise_scale)),
            obs=Normal('ts', obs_noise_scale),
        ),
    )
    Q = Plate(
        init=Normal(0, 1),
        T=Plate(
            ts=Normal(0, 1),
            obs=Data(),
        ),
    )
    platesizes = {"T": T}
    data = {"obs": dt_from_numpy(data_ts, ("T",), device)}
    return Problem(BoundPlate(P, platesizes, device=device),
                   BoundPlate(Q, platesizes, device=device), data, device=device)


def load_and_generate_problem(seed=0, Q_param_type=None, fake_data=True, data_dir=None,
                              return_fake_latents=False, device="cuda"):
    """(problem, None, None, None): the one fixed dataset (numpy seed 12)
    and no held-out part; Q has no parameters, so ``seed`` and
    ``Q_param_type`` change nothing."""
    if not fake_data or return_fake_latents:
        raise ValueError("ar1 has one fixed dataset and no fake latents")
    return generate_problem(device), None, None, None
