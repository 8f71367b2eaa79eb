"""Chimpanzees hierarchical logistic regression (counterpart of
``examples/models/chimpanzees.py``): 7 actors x 6 blocks x 10 repeats (12
over the extended plate), Bernoulli pulls of the left lever with logits
``alpha + alpha_actor + alpha_block + (beta_P + beta_PC condition)
prosoc_left``.

Fake data comes from a numpy seed at those shapes: ``condition`` and
``prosoc_left`` ~ Bernoulli(0.5), every latent from the prior, then the
pulls.  ``fake_data=False`` reads the reference's ``condition_*``,
``prosoc_left_*`` and ``data_*`` train/test files from ``data_dir``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..bound import BoundPlate
from ..ir import Bernoulli, Data, Group, Normal, OptParam, Plate, QEMParam
from ..problem import Problem
from ._realdata import check_fake, fake_latents, load_train_test, split_dts

num_actors, num_blocks = 7, 6
num_repeats, num_repeats_extended = 10, 12
_DIMS = ("plate_actors", "plate_blocks", "plate_repeats")

name = "chimpanzees"


def fake_arrays(seed=0):
    """numpy ``condition``, ``prosoc_left`` and ``obs`` (actors, blocks,
    12 repeats), and the latents they were drawn from."""
    rng = np.random.default_rng(seed)
    shape = (num_actors, num_blocks, num_repeats_extended)
    cond = (rng.random(shape) < 0.5).astype(np.float32)
    pleft = (rng.random(shape) < 0.5).astype(np.float32)
    lat = {"sigma_block": rng.normal(), "sigma_actor": rng.normal(),
           "beta_PC": rng.normal(0, 10), "beta_P": rng.normal(0, 10),
           "alpha": rng.normal(0, 10)}
    lat["alpha_actor"] = rng.normal(0, math.exp(lat["sigma_actor"]), num_actors)
    lat["alpha_block"] = rng.normal(0, math.exp(lat["sigma_block"]),
                                    (num_actors, num_blocks))
    logits = (lat["alpha"] + lat["alpha_actor"][:, None, None]
              + lat["alpha_block"][:, :, None]
              + (lat["beta_P"] + lat["beta_PC"] * cond) * pleft)
    obs = (rng.random(shape) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    out = {"condition": cond, "prosoc_left": pleft, "obs": obs}
    out.update({k: np.asarray(v, np.float32) for k, v in lat.items()})
    return out


def load_data_covariates(seed=0, fake_data=True, data_dir="data/", device="cuda",
                         return_fake_latents=False):
    """(platesizes, all_platesizes, data, all_data, covariates,
    all_covariates) on ``device``, and with ``return_fake_latents`` the
    latents the fake data were drawn from (``_realdata.fake_latents``)."""
    check_fake(fake_data, return_fake_latents)
    if fake_data:
        a = fake_arrays(seed)
        cov = {k: a[k] for k in ("condition", "prosoc_left")}
        obs = a["obs"]
    else:
        cov = {"condition": load_train_test(data_dir, "condition_train",
                                            "condition_test", axis=-1)[1],
               "prosoc_left": load_train_test(data_dir, "prosoc_left_train",
                                              "prosoc_left_test", axis=-1)[1]}
        obs = load_train_test(data_dir, "data_train", "data_test", axis=-1)[1]
    covariates, all_covariates = split_dts(cov, _DIMS, 2, num_repeats, device)
    data, all_data = split_dts({"obs": obs}, _DIMS, 2, num_repeats, device)
    sizes = dict(zip(_DIMS, obs.shape))
    out = ({**sizes, "plate_repeats": num_repeats}, sizes,
           data, all_data, covariates, all_covariates)
    if return_fake_latents:
        out += (fake_latents(get_P(out[1], out[5], device), a, all_data, _DIMS,
                             device),)
    return out


def get_P(platesizes, covariates, device="cuda"):
    P = Plate(
        sigma_block=Normal(0., 1.),
        sigma_actor=Normal(0., 1.),
        beta_PC=Normal(0., 10.),
        beta_P=Normal(0., 10.),
        alpha=Normal(0., 10.),
        plate_actors=Plate(
            alpha_actor=Normal(0., lambda sigma_actor: sigma_actor.exp()),
            plate_blocks=Plate(
                alpha_block=Normal(0., lambda sigma_block: sigma_block.exp()),
                plate_repeats=Plate(
                    obs=Bernoulli(logits=lambda alpha, alpha_block, alpha_actor,
                                  beta_PC, beta_P, condition, prosoc_left:
                                  alpha + alpha_actor + alpha_block
                                  + (beta_P + beta_PC * condition) * prosoc_left),
                ),
            ),
        ),
    )
    return BoundPlate(P, platesizes, inputs=covariates, device=device)


def generate_problem(platesizes, data, covariates, Q_param_type="qem", device="cuda"):
    P = get_P(platesizes, covariates, device)

    def ls(scale_init=1.0):
        if Q_param_type == "opt":
            return (OptParam(0.), OptParam(math.log(scale_init), transformation=torch.exp))
        if Q_param_type != "qem":
            raise ValueError(f"Q_param_type must be 'qem' or 'opt', not {Q_param_type!r}")
        return (QEMParam(0.), QEMParam(scale_init))

    Q = Plate(
        global_latents=Group(
            sigma_block=Normal(*ls()),
            sigma_actor=Normal(*ls()),
            beta_PC=Normal(*ls(10.)),
            beta_P=Normal(*ls(10.)),
            alpha=Normal(*ls(10.)),
        ),
        plate_actors=Plate(
            alpha_actor=Normal(*ls()),
            plate_blocks=Plate(
                alpha_block=Normal(*ls()),
                plate_repeats=Plate(obs=Data()),
            ),
        ),
    )
    Q = BoundPlate(Q, platesizes, inputs=covariates, device=device)
    return Problem(P, Q, data, device=device)


def load_and_generate_problem(seed=0, Q_param_type="qem", fake_data=True,
                              data_dir="data/", return_fake_latents=False, device="cuda"):
    """(problem, all_data, all_covariates, all_platesizes), and with
    ``return_fake_latents`` the latents the fake data were drawn from."""
    out = load_data_covariates(seed, fake_data, data_dir, device,
                               return_fake_latents=return_fake_latents)
    ps, all_ps, data, all_data, cov, all_cov = out[:6]
    problem = generate_problem(ps, data, cov, Q_param_type, device)
    return (problem, all_data, all_cov, all_ps, *out[6:])
