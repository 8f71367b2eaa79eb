"""The port's five ``_reparam`` canonical models (``alan_tpu_torch/models/``:
movielens_reparam, bus_breakdown_reparam, occupancy_reparam, radon_reparam,
covid_reparam), each of which rescales one latent, against ``alan_tpu``'s
``examples/models/``, each with the Q of its pair in
``tests/test_examples.py:15-46``, on ``alan_tpu``'s data and particles
(``tests/canonical_parity.py``); the port on the CPU.

* the ELBO at K = 3 within 1e-5 relative and every latent's mean within
  rtol/atol 1e-4;
* a QEM pair: one QEM step's ELBO and updated state (1e-5, 1e-4); an opt
  pair (bus_breakdown_reparam, covid_reparam): one RWS step's ELBO and
  gradients (1e-5, 1e-4);
* covid_reparam at 4 regions x 16 days (``tests/test_examples.py:41-46``),
  with counts of a few hundred (``tests/test_torch_timeseries.py``'s
  ``covid_setup`` says why) and the low-rank factored path forced in both
  packages, as at full size.  Its chain underflows in ``alan_tpu`` at Q's
  initial state: the port's joint-shift repair takes those entries, and
  the port is held against itself with an exact float64 chain, and with
  the repair off against ``alan_tpu``;
* the predictive log-likelihood of bus_breakdown_reparam's 150 held-out
  IDs, 1e-5 relative;
* each model's own numpy fake data at the published sizes;
* movielens_reparam's real-data loader on ``.npy`` files written here,
  against alan_tpu's.
"""
import numpy as np
import pytest

import canonical_parity as cp
from test_torch_harness import jax_dt

#: the low-rank factored path for covid's cross-K log_infected factor
COVID_LOWRANK = dict(ALAN_TPU_LOWRANK_MIN=1, ALAN_TPU_LAZY_LOWRANK=1)


def _covid_counts(jdata, all_jdata):
    obs = np.random.default_rng(4).poisson(300.0, (4, 16)).astype(np.float32)
    return ({"obs": jax_dt(obs[:, :12], "nRs", "nDs")},
            {"obs": jax_dt(obs, "nRs", "nDs")})


PAIRS = {"movielens_reparam": ("qem", {}), "bus_breakdown_reparam": ("opt", {}),
         "occupancy_reparam": ("qem", {}), "radon_reparam": ("qem", {}),
         "covid_reparam": ("opt", dict(load_kw={"nRs": 4, "nDs": 16}, env=COVID_LOWRANK,
                                       data=_covid_counts))}


@pytest.fixture(params=list(PAIRS))
def case(request):
    qtype, kw = PAIRS[request.param]
    return cp.case(request.param, qtype, **kw)


def test_elbo_and_moments_match_jax(case):
    joints = cp.check_elbo_and_moments(case)
    assert (joints > 0) == (case.name == "covid_reparam")


def test_step_matches_jax(case):
    if case.qtype == "qem":
        joints = cp.check_qem_step(case)
    else:
        joints = cp.check_gradients(case, "rws")
    assert (joints > 0) == (case.name == "covid_reparam")


def test_bus_breakdown_reparam_predictive_ll_matches_jax():
    cp.check_predictive_ll(cp.case("bus_breakdown_reparam", "opt"))


def test_own_fake_data_at_published_sizes(case):
    cp.check_own_data(case, **PAIRS[case.name][1].get("load_kw", {}))


def test_movielens_reparam_real_data_loader(tmp_path):
    rng = np.random.default_rng(0)
    M, N = 300, 5
    arrays = {}
    for prefix in ("", "test_"):
        arrays[f"{prefix}weights_{N}_{M}"] = rng.standard_normal((M, N, 18)).astype(np.float32)
        arrays[f"{prefix}data_y_{N}_{M}"] = (rng.random((M, N)) < 0.5).astype(np.float32)
    cp.check_real_data_loader("movielens_reparam", arrays, tmp_path)
