"""Bird occupancy model (counterpart of ``examples/models/occupancy.py``):
6 Years x 12 Birds x 200 Ids (300 over the extended plate) x 5 Replicates.
Each site's presence ``z`` is a discrete latent, Bernoulli with logits
``bird_year_mean weather beta``; each replicate's detection is Bernoulli
with logits ``alpha quality z - 10 (1 - z)``.  Q over ``z`` is a Bernoulli
with a QEM ``probs`` (0.5 at first) or an opt ``logits`` (0).

Fake data comes from a numpy seed at those shapes: ``weather`` and
``quality`` ~ N(0, 1), every latent from the prior, then the detections.
``fake_data=False`` reads the reference's ``weather_*``, ``quality_*`` and
``birds_*`` train/test files of run ``run`` from ``data_dir``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..bound import BoundPlate
from ..ir import Bernoulli, Data, Group, Normal, OptParam, Plate, QEMParam
from ..problem import Problem
from ._realdata import check_fake, fake_latents, load_train_test, split_dts

M, J, I, Returns = 6, 12, 200, 5
I_extended = 300
_DIMS = ("plate_Years", "plate_Birds", "plate_Ids")

name = "occupancy"


def fake_arrays(seed=0):
    """numpy ``weather``, ``quality`` (Years, Birds, 300 Ids), ``obs``
    (Years, Birds, 300 Ids, Replicate), and the latents they were drawn
    from."""
    rng = np.random.default_rng(seed)
    weather = rng.standard_normal((M, J, I_extended)).astype(np.float32)
    quality = rng.standard_normal((M, J, I_extended)).astype(np.float32)
    lat = {k: rng.normal() for k in ("bird_mean_mean", "bird_mean_log_var", "alpha_mean",
                                     "alpha_log_var", "beta_mean", "beta_log_var")}
    for k in ("bird_mean", "alpha", "beta"):
        lat[k] = rng.normal(lat[f"{k}_mean" if k != "bird_mean" else "bird_mean_mean"],
                            math.exp(lat[f"{k}_log_var"]), J)
    lat["bird_year_mean"] = rng.normal(lat["bird_mean"][None, :], 1.0, (M, J))
    p_z = 1 / (1 + np.exp(-lat["bird_year_mean"][:, :, None] * weather
                          * lat["beta"][None, :, None]))
    lat["z"] = (rng.random((M, J, I_extended)) < p_z).astype(np.float32)
    z = lat["z"][..., None]
    logits = lat["alpha"][None, :, None, None] * quality[..., None] * z + (1 - z) * -10.0
    obs = (rng.random((M, J, I_extended, Returns)) < 1 / (1 + np.exp(-logits)))
    out = {"weather": weather, "quality": quality, "obs": obs.astype(np.float32)}
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
        cov = {k: a[k] for k in ("weather", "quality")}
        obs = a["obs"]
    else:
        cov = {k: load_train_test(data_dir, f"{k}_train_{run}", f"{k}_test_{run}", axis=-1)[1]
               for k in ("weather", "quality")}
        obs = load_train_test(data_dir, f"birds_train_{run}", f"birds_test_{run}",
                              axis=-2)[1]
    covariates, all_covariates = split_dts(cov, _DIMS, 2, I, device)
    data, all_data = split_dts({"obs": obs}, (*_DIMS, "plate_Replicate"), 2, I, device)
    out = ({"plate_Years": M, "plate_Birds": J, "plate_Ids": I, "plate_Replicate": Returns},
           {"plate_Years": M, "plate_Birds": J, "plate_Ids": I_extended,
            "plate_Replicate": Returns},
           data, all_data, covariates, all_covariates)
    if return_fake_latents:
        out += (fake_latents(get_P(out[1], out[5], device), a, all_data,
                             (*_DIMS, "plate_Replicate"), device),)
    return out


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
                bird_year_mean=Normal("bird_mean", 1.),
                plate_Ids=Plate(
                    z=Bernoulli(logits=lambda weather, bird_year_mean, beta:
                                bird_year_mean * weather * beta),
                    plate_Replicate=Plate(
                        obs=Bernoulli(logits=lambda alpha, quality, z:
                                      alpha * quality * z + (1 - z) * (-10)),
                    ),
                ),
            ),
        ),
    )
    return BoundPlate(P, platesizes, inputs=covariates, device=device)


def generate_problem(platesizes, data, covariates, Q_param_type="qem", device="cuda",
                     get_P=get_P, bird_year_mean_scale=1.0):
    """Occupancy with a factorised Q: Normals for the continuous latents, a
    Bernoulli for ``z``; ``get_P`` and the initial scale of
    bird_year_mean's proposal are occupancy_reparam's hooks."""
    if Q_param_type not in ("qem", "opt"):
        raise ValueError(f"Q_param_type must be 'qem' or 'opt', not {Q_param_type!r}")
    P = get_P(platesizes, covariates, device)

    def ls(scale_init=1.0):
        if Q_param_type == "opt":
            return (OptParam(0.), OptParam(math.log(scale_init), transformation=torch.exp))
        return (QEMParam(0.), QEMParam(scale_init))

    def bern():
        if Q_param_type == "opt":
            return Bernoulli(logits=OptParam(0.))
        return Bernoulli(probs=QEMParam(0.5))

    Q = Plate(
        global_latents=Group(
            bird_mean_mean=Normal(*ls()),
            bird_mean_log_var=Normal(*ls()),
            alpha_mean=Normal(*ls()),
            alpha_log_var=Normal(*ls()),
            beta_mean=Normal(*ls()),
            beta_log_var=Normal(*ls()),
        ),
        plate_Birds=Plate(
            bird_latents=Group(
                bird_mean=Normal(*ls()),
                alpha=Normal(*ls()),
                beta=Normal(*ls()),
            ),
            plate_Years=Plate(
                bird_year_mean=Normal(*ls(bird_year_mean_scale)),
                plate_Ids=Plate(
                    z=bern(),
                    plate_Replicate=Plate(obs=Data()),
                ),
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
