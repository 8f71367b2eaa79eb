"""MovieLens factor model (counterpart of ``examples/models/movielens.py``
and of ``_grouped_movielens`` in ``bench_scaling.py:70-93``): M=300 users x
N=5 films, d_z=18 latent factors, Bernoulli observations with logits z . x.

Q is a factorised Normal whose parameters are QEM parameters
(``Q_param_type="qem"``) or opt params, a location and a log-scale
(``"opt"``, ``examples/models/movielens.py:79-90``), for VI and RWS.

Fake data comes from a numpy seed (:func:`fake_data`), so the same arrays
can feed this package and ``alan_tpu``: covariates ``x ~ N(0, 1)``, latents
from the prior, ``obs ~ Bernoulli(sigmoid(z . x))``; held-out films, for
the predictive log-likelihood, are drawn after them from the same users'
``z`` (:func:`load_all_data_covariates`, the counterpart of
``examples/models/movielens.py:21-63``'s ``all_platesizes``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..bound import BoundPlate
from ..convert import dt_from_numpy
from ..ir import Bernoulli, Data, Group, Normal, OptParam, Plate, QEMParam
from ..problem import Problem
from ._realdata import check_fake, fake_latents, load_train_test

d_z = 18
M, N = 300, 5


def fake_data(seed=0, M=M, N=N, N_test=0):
    """numpy arrays ``x`` (M, N, d_z), ``obs`` (M, N), the latents
    ``mu_z``, ``psi_z`` (d_z,) and ``z`` (M, d_z) they were drawn from, and
    ``x_test`` (M, N_test, d_z), ``obs_test`` (M, N_test) of held-out films,
    drawn after everything else, so the other arrays do not depend on
    ``N_test``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, N, d_z)).astype(np.float32)
    mu_z = rng.standard_normal(d_z).astype(np.float32)
    psi_z = rng.standard_normal(d_z).astype(np.float32)
    z = (mu_z + np.exp(psi_z) * rng.standard_normal((M, d_z))).astype(np.float32)

    def observe(x):
        logits = np.einsum("mf,mnf->mn", z, x)
        return (rng.random(logits.shape) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)

    obs = observe(x)
    x_test = rng.standard_normal((M, N_test, d_z)).astype(np.float32)
    obs_test = observe(x_test)
    return {"x": x, "obs": obs, "mu_z": mu_z, "psi_z": psi_z, "z": z,
            "x_test": x_test, "obs_test": obs_test}


_fake_arrays = fake_data      # load_train_all's fake_data is its flag


def load_data_covariates(seed=0, M=M, N=N, device="cuda"):
    """(platesizes, data, covariates) of a fake dataset, on ``device``."""
    arrays = fake_data(seed, M, N)
    plates = ("plate_1", "plate_2")
    covariates = {"x": dt_from_numpy(arrays["x"], plates, device)}
    data = {"obs": dt_from_numpy(arrays["obs"], plates, device)}
    return {"plate_1": M, "plate_2": N}, data, covariates


def load_all_data_covariates(seed=0, M=M, N=N, N_test=N, device="cuda"):
    """(all_platesizes, all_data, all_covariates) over the N training films
    and N_test held-out ones, on ``device``: the extended plates of
    ``predict.predictive_ll_fn``."""
    arrays = fake_data(seed, M, N, N_test)
    plates = ("plate_1", "plate_2")
    cat = lambda a, b: np.concatenate([arrays[a], arrays[b]], axis=1)
    covariates = {"x": dt_from_numpy(cat("x", "x_test"), plates, device)}
    data = {"obs": dt_from_numpy(cat("obs", "obs_test"), plates, device)}
    return {"plate_1": M, "plate_2": N + N_test}, data, covariates


def load_train_all(seed=0, fake_data=True, data_dir="data/", M=M, N=N,
                   return_fake_latents=False, device="cuda"):
    """(platesizes, all_platesizes, data, all_data, covariates,
    all_covariates) on ``device``: N training films and N held out, the
    fake data of :func:`fake_data` (with ``return_fake_latents`` also the
    latents they were drawn from, ``_realdata.fake_latents``) or with
    ``fake_data=False`` the reference's ``weights_{N}_{M}`` and
    ``data_y_{N}_{M}`` train/test files from ``data_dir``."""
    check_fake(fake_data, return_fake_latents)
    if fake_data:
        ps, data, cov = load_data_covariates(seed, M, N, device)
        all_ps, all_data, all_cov = load_all_data_covariates(seed, M, N, N, device)
        out = (ps, all_ps, data, all_data, cov, all_cov)
        if return_fake_latents:
            out += (fake_latents(get_P(all_ps, all_cov, device), _fake_arrays(seed, M, N),
                                 all_data, ("plate_1", "plate_2"), device),)
        return out
    x, x_all = load_train_test(data_dir, f"weights_{N}_{M}", f"test_weights_{N}_{M}", axis=-2)
    y, y_all = load_train_test(data_dir, f"data_y_{N}_{M}", f"test_data_y_{N}_{M}", axis=-1)
    plates = ("plate_1", "plate_2")
    dt = lambda a: dt_from_numpy(a, plates, device)
    return ({"plate_1": M, "plate_2": N}, {"plate_1": M, "plate_2": 2 * N},
            {"obs": dt(y)}, {"obs": dt(y_all)}, {"x": dt(x)}, {"x": dt(x_all)})


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


def _q_normal(Q_param_type):
    if Q_param_type == "opt":
        return Normal(OptParam(torch.zeros(d_z)),
                      OptParam(torch.zeros(d_z), transformation=torch.exp))
    if Q_param_type != "qem":
        raise ValueError(f"Q_param_type must be 'qem' or 'opt', not {Q_param_type!r}")
    return Normal(QEMParam(torch.zeros(d_z)), QEMParam(torch.ones(d_z)))


def generate_problem(platesizes, data, covariates, Q_param_type="qem",
                     device="cuda"):
    """MovieLens whose every latent has its own K-dim."""
    P = get_P(platesizes, covariates, device)
    Q = Plate(
        mu_z=_q_normal(Q_param_type),
        psi_z=_q_normal(Q_param_type),
        plate_1=Plate(z=_q_normal(Q_param_type), plate_2=Plate(obs=Data())),
    )
    Q = BoundPlate(Q, platesizes, inputs=covariates, device=device)
    return Problem(P, Q, data, device=device)


def grouped_problem(platesizes, data, covariates, Q_param_type="qem",
                    device="cuda"):
    """MovieLens with mu_z and psi_z grouped onto one K-dim: the z factor
    shrinks from K^3 x plate to K^2 x plate, which is what makes K=1000
    feasible, and routes z's cross-K factor through the lazy contraction.
    With opt params in Q (for VI) both sides of that factor depend on them,
    z's draw on one side and mu_z's and psi_z's on the other, so a VI step
    takes the lazy contraction's gradients with respect to both operands."""
    P = get_P(platesizes, covariates, device)
    Q = Plate(
        g=Group(mu_z=_q_normal(Q_param_type), psi_z=_q_normal(Q_param_type)),
        plate_1=Plate(z=_q_normal(Q_param_type), plate_2=Plate(obs=Data())),
    )
    Q = BoundPlate(Q, platesizes, inputs=covariates, device=device)
    return Problem(P, Q, data, device=device)


def load_and_generate_problem(seed=0, Q_param_type="qem", fake_data=True,
                              data_dir="data/", return_fake_latents=False, device="cuda"):
    """(problem, all_data, all_covariates, all_platesizes) of the ungrouped
    model at the published size (:func:`load_train_all`), and with
    ``return_fake_latents`` the latents the fake data were drawn from."""
    out = load_train_all(seed, fake_data, data_dir, return_fake_latents=return_fake_latents,
                         device=device)
    ps, all_ps, data, all_data, cov, all_cov = out[:6]
    problem = generate_problem(ps, data, cov, Q_param_type, device=device)
    return (problem, all_data, all_cov, all_ps, *out[6:])
