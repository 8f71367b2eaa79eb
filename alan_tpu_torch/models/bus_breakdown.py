"""NYC bus-breakdown hierarchy (counterpart of
``examples/models/bus_breakdown.py``): 2 Years x 3 Boroughs x 150 IDs (300
over the extended plate), Bernoulli delays with logits ``alpha + phi .
bus_company_name + psi . run_type``, where ``phi`` (4) and ``psi`` (2) are
vector latents and the covariates one-hot-like vectors: a vector . vector
``DT`` product per site.

Fake data comes from a numpy seed at those shapes: the covariates ~
Bernoulli(0.5), every latent from the prior, then the delays.
``fake_data=False`` reads the reference's ``run_type_*``,
``bus_company_name_*`` and ``delay_*`` train/test files of run ``run``
from ``data_dir``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..bound import BoundPlate
from ..ir import Bernoulli, Data, Group, Normal, OptParam, Plate, QEMParam
from ..problem import Problem
from ._realdata import check_fake, fake_latents, load_train_test, split_dts

M, J, I = 2, 3, 150
run_type_dim = 2
bus_company_name_dim = 4
_DIMS = ("plate_Year", "plate_Borough", "plate_ID")

name = "bus_breakdown"


def fake_arrays(seed=0):
    """numpy ``run_type`` (M, J, 2I, 2), ``bus_company_name`` (M, J, 2I,
    4), ``obs`` (M, J, 2I), and the latents they were drawn from."""
    rng = np.random.default_rng(seed)
    rt = (rng.random((M, J, 2 * I, run_type_dim)) < 0.5).astype(np.float32)
    bc = (rng.random((M, J, 2 * I, bus_company_name_dim)) < 0.5).astype(np.float32)
    lat = {"psi": rng.normal(0, 1, run_type_dim), "phi": rng.normal(0, 1, bus_company_name_dim),
           "sigma_beta": rng.normal(), "mu_beta": rng.normal()}
    lat["beta"] = rng.normal(lat["mu_beta"], math.exp(lat["sigma_beta"]), M)
    lat["sigma_alpha"] = rng.normal(0, 1, M)
    lat["alpha"] = rng.normal(lat["beta"][:, None], np.exp(lat["sigma_alpha"])[:, None], (M, J))
    logits = lat["alpha"][:, :, None] + bc @ lat["phi"] + rt @ lat["psi"]
    obs = (rng.random((M, J, 2 * I)) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    out = {"run_type": rt, "bus_company_name": bc, "obs": obs}
    out.update({k: np.asarray(v, np.float32) for k, v in lat.items()})
    return out


def load_data_covariates(seed=0, fake_data=True, data_dir="data/", run=0, device="cuda",
                         return_fake_latents=False):
    """(platesizes, all_platesizes, data, all_data, covariates,
    all_covariates) on ``device``, and with ``return_fake_latents`` the
    latents the fake data were drawn from (``_realdata.fake_latents``)."""
    check_fake(fake_data, return_fake_latents)
    if fake_data:
        a = fake_arrays(seed)
        cov = {k: a[k] for k in ("run_type", "bus_company_name")}
        obs = a["obs"]
    else:
        cov = {k: load_train_test(data_dir, f"{k}_train_{run}", f"{k}_test_{run}", axis=2)[1]
               for k in ("run_type", "bus_company_name")}
        obs = load_train_test(data_dir, f"delay_train_{run}", f"delay_test_{run}",
                              axis=-1)[1]
    covariates, all_covariates = split_dts(cov, _DIMS, 2, I, device)
    data, all_data = split_dts({"obs": obs}, _DIMS, 2, I, device)
    out = ({"plate_Year": M, "plate_Borough": J, "plate_ID": I},
           {"plate_Year": M, "plate_Borough": J, "plate_ID": 2 * I},
           data, all_data, covariates, all_covariates)
    if return_fake_latents:
        out += (fake_latents(get_P(out[1], out[5], device), a, all_data, _DIMS,
                             device),)
    return out


def get_P(platesizes, covariates, device="cuda"):
    P = Plate(
        psi=Normal(torch.zeros(run_type_dim), torch.ones(run_type_dim)),
        phi=Normal(torch.zeros(bus_company_name_dim), torch.ones(bus_company_name_dim)),
        sigma_beta=Normal(0, 1),
        mu_beta=Normal(0, 1),
        plate_Year=Plate(
            beta=Normal("mu_beta", lambda sigma_beta: sigma_beta.exp()),
            sigma_alpha=Normal(0, 1),
            plate_Borough=Plate(
                alpha=Normal("beta", lambda sigma_alpha: sigma_alpha.exp()),
                plate_ID=Plate(
                    obs=Bernoulli(logits=lambda alpha, phi, psi, run_type, bus_company_name:
                                  alpha + phi @ bus_company_name + psi @ run_type),
                ),
            ),
        ),
    )
    return BoundPlate(P, platesizes, inputs=covariates, device=device)


def loc_scale(Q_param_type, shape=None, scale_init=1.0):
    """The (loc, scale) parameters of a Normal in Q, of ``shape`` (a
    scalar by default): QEM parameters, or opt params (a location and a
    log-scale)."""
    full = (lambda v: torch.full(shape, float(v))) if shape else float
    if Q_param_type == "opt":
        return (OptParam(full(0.)), OptParam(full(math.log(scale_init)),
                                             transformation=torch.exp))
    if Q_param_type != "qem":
        raise ValueError(f"Q_param_type must be 'qem' or 'opt', not {Q_param_type!r}")
    return (QEMParam(full(0.)), QEMParam(full(scale_init)))


def generate_problem(platesizes, data, covariates, Q_param_type="qem", device="cuda",
                     get_P=get_P, alpha_scale=1.0):
    """Bus-breakdown with a factorised Normal Q; ``get_P`` and the initial
    scale of alpha's proposal are bus_breakdown_reparam's hooks."""
    P = get_P(platesizes, covariates, device)
    ls = lambda shape=None, scale=1.0: loc_scale(Q_param_type, shape, scale)
    Q = Plate(
        global_latents=Group(
            psi=Normal(*ls((run_type_dim,))),
            phi=Normal(*ls((bus_company_name_dim,))),
            sigma_beta=Normal(*ls()),
            mu_beta=Normal(*ls()),
        ),
        plate_Year=Plate(
            year_latents=Group(
                beta=Normal(*ls()),
                sigma_alpha=Normal(*ls()),
            ),
            plate_Borough=Plate(
                alpha=Normal(*ls(scale=alpha_scale)),
                plate_ID=Plate(obs=Data()),
            ),
        ),
    )
    Q = BoundPlate(Q, platesizes, inputs=covariates, device=device)
    return Problem(P, Q, data, device=device)


def load_and_generate_problem(seed=0, Q_param_type="qem", fake_data=True,
                              data_dir="data/", run=0, return_fake_latents=False, device="cuda"):
    """(problem, all_data, all_covariates, all_platesizes), and with
    ``return_fake_latents`` the latents the fake data were drawn from."""
    out = load_data_covariates(seed, fake_data, data_dir, run, device,
                               return_fake_latents=return_fake_latents)
    ps, all_ps, data, all_data, cov, all_cov = out[:6]
    problem = generate_problem(ps, data, cov, Q_param_type, device)
    return (problem, all_data, all_cov, all_ps, *out[6:])
