"""COVID NPI model with a badly scaled ``Wearing_alpha`` (counterpart of
``examples/models/covid_reparam.py``): divided by SCALE = 10^4 in the
prior and multiplied back inside the ``log_infected`` transition mean, so
Q must learn a scale of ~1/SCALE.  The data are covid's (the observation
law is unchanged): 92 regions x 137 days, training on 109.  Its
``log_infected`` chain (nRs * K chains of T = 109 operators of K x K) runs
through the small-K chain kernels, as covid's does.

``fake_data=False`` reads covid's files from ``data_dir`` (the reference's
pre-split ``ActiveCMs_*`` and ``obs`` arrays, train and ``_all``).
"""
from __future__ import annotations

import math

from ..bound import BoundPlate
from ..ir import NegativeBinomial, Normal, Plate, Timeseries
from . import covid as base

nCMs = base.nCMs
SCALE = 10000.0

name = "covid_reparam"


def load_data_covariates(seed=0, fake_data=True, data_dir="data/", nRs=base.nRs,
                         nDs=base.nDs, device="cuda"):
    """(platesizes, all_platesizes, data, all_data, covariates,
    all_covariates) on ``device``: covid's fake data, or its files."""
    if fake_data:
        return base.load_data_covariates(seed, nRs, nDs, device)
    return base.load_real_data(data_dir, device)


def get_P(platesizes, covariates, corr_CM=False, device="cuda"):
    """The prior, Wearing_alpha rescaled (``corr_CM`` is refused: the
    reference's reparameterised model has no corr_Q form)."""
    if corr_CM:
        raise ValueError("covid_reparam has no corr_Q form")
    cm_prior_scale = 1
    wearing_mean, wearing_sigma = 0, 0.4
    mobility_mean, mobility_sigma = 1.704, 0.44
    R_prior_mean_mean, R_prior_mean_scale = 1.07, 0.2
    R_noise_scale = 0.4

    Expected_Log_Rs = lambda RegionR, CM_alpha, ActiveCMs_NPIs, Wearing_alpha, \
        ActiveCMs_wearing, Mobility_alpha, ActiveCMs_mobility, prev: \
        RegionR + CM_alpha @ ActiveCMs_NPIs + SCALE * Wearing_alpha * ActiveCMs_wearing \
        + Mobility_alpha * ActiveCMs_mobility + prev

    P = Plate(
        CM_alpha=Normal(0, cm_prior_scale, sample_shape=[nCMs - 2]),
        Wearing_alpha=Normal(wearing_mean / SCALE, wearing_sigma / SCALE),
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


def generate_problem(platesizes, data, covariates, Q_param_type="opt", device="cuda"):
    """covid's factorised Normal Q, Wearing_alpha's proposal at scale
    1/SCALE."""
    return base.generate_problem(platesizes, data, covariates, Q_param_type, device=device,
                                 get_P=get_P, wearing_scale=1.0 / SCALE)


def load_and_generate_problem(seed=0, Q_param_type="opt", fake_data=True,
                              data_dir="data/", nRs=base.nRs, nDs=base.nDs, device="cuda"):
    """(problem, all_data, all_covariates, all_platesizes)."""
    ps, all_ps, data, all_data, cov, all_cov = load_data_covariates(
        seed, fake_data, data_dir, nRs, nDs, device)
    return generate_problem(ps, data, cov, Q_param_type, device), all_data, all_cov, all_ps
