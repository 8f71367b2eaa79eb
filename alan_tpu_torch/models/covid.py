"""COVID NPI model (counterpart of ``examples/models/covid.py``): nRs = 92
regions x nDs = 137 days, a first-order Markov ``log_infected`` chain per
region (a Timeseries over the days) and NegativeBinomial case counts.
Training uses the first ``int(0.8 * nDs) = 109`` days.

Fake data comes from a numpy seed (:func:`fake_data`) by the recipe of
``covid.load_data_covariates``: NPIs ~ Bernoulli(0.3), wearing and mobility
~ U(0, 1), every latent drawn from the prior, the ``log_infected``
recursion, and NegativeBinomial observations.  The same arrays can feed
this package and ``alan_tpu``.

Q is a factorised Normal whose parameters are opt params, a location and a
log-scale (``Q_param_type="opt"``, the default, as ``alan_tpu``'s: VI and
RWS), or QEM parameters (``"qem"``).  With ``corr_Q`` (QEM only) the NPI
coefficients CM_alpha take a full-covariance MultivariateNormal proposal
(location ``QEMParam(zeros(9))``, covariance ``QEMParam(eye(9))``), and P
states their prior as the same MultivariateNormal, so that the supports
match.  Either way the chain operator of
``log_infected`` is ``[nRs, K_npis, T, K_a, K_log_infected]``: nRs * K
chains of T = 109 operators of K x K, which the small-K chain kernel
contracts.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..bound import BoundPlate
from ..convert import dt_from_numpy
from ..ir import (Data, Group, MultivariateNormal, NegativeBinomial, Normal,
                  OptParam, Plate, QEMParam, Timeseries)
from ..problem import Problem
from ._realdata import check_fake, fake_latents, load_array

nRs = 92
nDs = 137
nCMs = 11

_PLATES = ("nRs", "nDs")


def fake_data(seed=0, nRs=nRs, nDs=nDs):
    """numpy arrays over all ``nDs`` days: covariates ``npis`` (nRs, nDs,
    nCMs - 2), ``wearing`` and ``mobility`` (nRs, nDs), observations ``obs``
    (nRs, nDs), and the latents they were drawn from."""
    rng = np.random.default_rng(seed)
    npis = (rng.random((nRs, nDs, nCMs - 2)) < 0.3).astype(np.float32)
    wearing = rng.random((nRs, nDs)).astype(np.float32)
    mobility = rng.random((nRs, nDs)).astype(np.float32)

    lat = {
        "CM_alpha": rng.normal(0.0, 1.0, nCMs - 2),
        "Wearing_alpha": rng.normal(0.0, 0.4),
        "Mobility_alpha": rng.normal(1.704, 0.44),
        "RegionR": rng.normal(1.07, 0.2 + 0.4),
        "InitialSize_log_mean": rng.normal(math.log(1000), 0.5),
        "log_infected_noise_mean": rng.normal(math.log(0.01), 0.25),
    }
    lat["InitialSize_log"] = rng.normal(lat["InitialSize_log_mean"], 0.5, nRs)
    lat["log_infected_noise"] = rng.normal(lat["log_infected_noise_mean"], 0.25, nRs)
    lat["psi"] = rng.normal(0.0, 1.0, nRs)

    log_infected = np.empty((nRs, nDs))
    prev = lat["InitialSize_log"]
    for t in range(nDs):
        mu = (lat["RegionR"] + npis[:, t] @ lat["CM_alpha"]
              + lat["Wearing_alpha"] * wearing[:, t]
              + lat["Mobility_alpha"] * mobility[:, t] + prev)
        prev = rng.normal(mu, np.exp(lat["log_infected_noise"]))
        log_infected[:, t] = prev
    lat["log_infected"] = log_infected

    r = np.exp(lat["psi"])[:, None]
    probs = 1.0 / (r * np.exp(-log_infected) + 1 + 1e-7)
    lam = rng.gamma(np.broadcast_to(r, probs.shape)) * probs / (1.0 - probs)
    obs = rng.poisson(lam).astype(np.float32)
    out = {"npis": npis, "wearing": wearing, "mobility": mobility, "obs": obs}
    out.update({k: np.asarray(v, np.float32) for k, v in lat.items()})
    return out


def load_data_covariates(seed=0, nRs=nRs, nDs=nDs, device="cuda",
                         return_fake_latents=False):
    """(platesizes, all_platesizes, data, all_data, covariates,
    all_covariates) of a fake dataset, on ``device``; the training part is
    the first ``int(0.8 * nDs)`` days.  With ``return_fake_latents`` also
    the latents the data were drawn from, over all ``nDs`` days
    (``_realdata.fake_latents``)."""
    arrays = fake_data(seed, nRs, nDs)
    nDs_train = int(nDs * 0.8)

    def split(a):
        return (dt_from_numpy(a[:, :nDs_train], _PLATES, device),
                dt_from_numpy(a, _PLATES, device))

    covariates, all_covariates = {}, {}
    for name, key in (("ActiveCMs_NPIs", "npis"), ("ActiveCMs_wearing", "wearing"),
                      ("ActiveCMs_mobility", "mobility")):
        covariates[name], all_covariates[name] = split(arrays[key])
    obs, all_obs = split(arrays["obs"])
    out = ({"nRs": nRs, "nDs": nDs_train}, {"nRs": nRs, "nDs": nDs},
           {"obs": obs}, {"obs": all_obs}, covariates, all_covariates)
    if return_fake_latents:
        out += (fake_latents(get_P(out[1], all_covariates, device=device), arrays,
                             out[3], _PLATES, device),)
    return out


_COVARIATES = ("ActiveCMs_NPIs", "ActiveCMs_wearing", "ActiveCMs_mobility")


def load_real_data(data_dir, device="cuda"):
    """(platesizes, all_platesizes, data, all_data, covariates,
    all_covariates) read from the reference's files in ``data_dir``: the
    pre-split ``ActiveCMs_*`` and ``obs`` arrays, train and ``_all``."""
    load = lambda stem: dt_from_numpy(load_array(data_dir, stem), _PLATES, device)
    covariates = {k: load(k) for k in _COVARIATES}
    all_covariates = {k: load(k + "_all") for k in _COVARIATES}
    obs, all_obs = load("obs"), load("obs_all")
    sizes = lambda t: dict(zip(_PLATES, t.data.shape))
    return (sizes(obs), sizes(all_obs), {"obs": obs}, {"obs": all_obs},
            covariates, all_covariates)


def get_P(platesizes, covariates, corr_CM=False, device="cuda"):
    """The prior.  ``corr_CM`` states CM_alpha's prior, N(0, I_9), as a
    MultivariateNormal (the real_vector support of the corr_Q proposal)."""
    cm_prior_scale = 1
    wearing_mean, wearing_sigma = 0, 0.4
    mobility_mean, mobility_sigma = 1.704, 0.44
    R_prior_mean_mean, R_prior_mean_scale = 1.07, 0.2
    R_noise_scale = 0.4

    Expected_Log_Rs = lambda RegionR, CM_alpha, ActiveCMs_NPIs, Wearing_alpha, \
        ActiveCMs_wearing, Mobility_alpha, ActiveCMs_mobility, prev: \
        RegionR + CM_alpha @ ActiveCMs_NPIs + Wearing_alpha * ActiveCMs_wearing \
        + Mobility_alpha * ActiveCMs_mobility + prev

    if corr_CM:
        cm_alpha_P = MultivariateNormal(
            torch.zeros(nCMs - 2),
            covariance_matrix=cm_prior_scale ** 2 * torch.eye(nCMs - 2))
    else:
        cm_alpha_P = Normal(0, cm_prior_scale, sample_shape=[nCMs - 2])
    P = Plate(
        CM_alpha=cm_alpha_P,
        Wearing_alpha=Normal(wearing_mean, wearing_sigma),
        Mobility_alpha=Normal(mobility_mean, mobility_sigma),
        RegionR=Normal(R_prior_mean_mean, R_prior_mean_scale + R_noise_scale),
        InitialSize_log_mean=Normal(math.log(1000), 0.5),
        log_infected_noise_mean=Normal(math.log(0.01), 0.25),
        nRs=Plate(
            InitialSize_log=Normal(lambda InitialSize_log_mean: InitialSize_log_mean, 0.5),
            log_infected_noise=Normal(lambda log_infected_noise_mean: log_infected_noise_mean, 0.25),
            psi=Normal(0, 1),
            nDs=Plate(
                log_infected=Timeseries('InitialSize_log',
                                        Normal(Expected_Log_Rs,
                                               lambda log_infected_noise: log_infected_noise.exp())),
                obs=NegativeBinomial(
                    total_count=lambda psi: psi.exp(),
                    probs=lambda log_infected, psi:
                    1.0 / ((psi.exp() / log_infected.exp()) + 1 + 1e-7)),
            ),
        ),
    )
    return BoundPlate(P, platesizes, inputs=covariates, device=device)


def generate_problem(platesizes, data, covariates, Q_param_type="opt",
                     corr_Q=False, device="cuda", get_P=get_P, wearing_scale=1.0):
    """The covid problem with a factorised Normal Q (``Q_param_type``
    ``"opt"`` or ``"qem"``; ``examples/models/covid.py:121-170``).  The
    JAX benchmark's ``covid_full_qem_K30`` is ``"qem"``.  ``corr_Q`` (QEM
    only) gives CM_alpha a full-covariance MultivariateNormal proposal:
    under a factorised Q the NPI coefficients stay biased at every K, as
    ``examples/models/covid.py:121-131`` sets out.  ``get_P`` and the
    initial scale of Wearing_alpha's proposal are covid_reparam's hooks."""
    if Q_param_type not in ("opt", "qem"):
        raise ValueError(f"Q_param_type must be 'opt' or 'qem', not {Q_param_type!r}")
    P = get_P(platesizes, covariates, corr_CM=corr_Q, device=device)

    def q(loc_init=0.0, scale_init=1.0, shape=None):
        full = (lambda v: torch.full(shape, float(v))) if shape else float
        if Q_param_type == "opt":
            return Normal(OptParam(full(loc_init)),
                          OptParam(full(math.log(scale_init)),
                                   transformation=torch.exp))
        return Normal(QEMParam(full(loc_init)), QEMParam(full(scale_init)))

    if corr_Q:
        if Q_param_type != "qem":
            raise ValueError("corr_Q covid Q requires Q_param_type='qem'")
        cm_alpha_Q = MultivariateNormal(
            QEMParam(torch.zeros(nCMs - 2)),
            covariance_matrix=QEMParam(torch.eye(nCMs - 2)))
    else:
        cm_alpha_Q = q(shape=(nCMs - 2,))
    Q = Plate(
        npis=Group(
            CM_alpha=cm_alpha_Q,
            Wearing_alpha=q(scale_init=wearing_scale),
            Mobility_alpha=q(),
            RegionR=q(loc_init=1.0),
            InitialSize_log_mean=q(loc_init=math.log(1000)),
            log_infected_noise_mean=q(loc_init=math.log(0.01)),
        ),
        nRs=Plate(
            a=Group(
                InitialSize_log=q(loc_init=math.log(1000)),
                log_infected_noise=q(loc_init=math.log(0.01)),
                psi=q(),
            ),
            nDs=Plate(
                log_infected=q(loc_init=math.log(1000)),
                obs=Data(),
            ),
        ),
    )
    Q = BoundPlate(Q, platesizes, inputs=covariates, device=device)
    return Problem(P, Q, data, device=device)


def load_and_generate_problem(seed=0, Q_param_type="opt", fake_data=True,
                              data_dir="data/", return_fake_latents=False, device="cuda"):
    """(problem, all_data, all_covariates, all_platesizes) at the published
    size, and with ``return_fake_latents`` the latents the fake data were
    drawn from; ``fake_data=False`` reads the reference's files from
    ``data_dir``."""
    check_fake(fake_data, return_fake_latents)
    out = (load_data_covariates(seed, device=device, return_fake_latents=return_fake_latents)
           if fake_data else load_real_data(data_dir, device))
    ps, all_ps, data, all_data, cov, all_cov = out[:6]
    problem = generate_problem(ps, data, cov, Q_param_type, device=device)
    return (problem, all_data, all_cov, all_ps, *out[6:])
