"""The port's five base canonical models (``alan_tpu_torch/models/``:
synthetic_model, radon, chimpanzees, bus_breakdown, occupancy) against
``alan_tpu``'s ``examples/models/``, each with the Q of its pair in
``tests/test_examples.py:15-29``, on ``alan_tpu``'s data and particles
(``tests/canonical_parity.py``); the port on the CPU.

* the ELBO at K = 3 within 1e-5 relative and every latent's mean within
  rtol/atol 1e-4;
* a QEM pair: one QEM step's ELBO and updated state (1e-5, 1e-4); the opt
  pair (chimpanzees): one VI step's ELBO and gradients (1e-5, 1e-4);
* the predictive log-likelihood of radon's 50 held-out Zips, 1e-5
  relative;
* each model's own numpy fake data at the published sizes: alan_tpu's
  plate sizes, a finite ELBO;
* chimpanzees' real-data loader on ``.npy`` files written here, against
  alan_tpu's.
"""
import numpy as np
import pytest

import canonical_parity as cp

PAIRS = [("synthetic_model", "qem"), ("radon", "qem"), ("chimpanzees", "opt"),
         ("bus_breakdown", "qem"), ("occupancy", "qem")]


@pytest.fixture(params=PAIRS, ids=[n for n, _ in PAIRS])
def case(request):
    return cp.case(*request.param)


def test_elbo_and_moments_match_jax(case):
    assert cp.check_elbo_and_moments(case) == 0


def test_step_matches_jax(case):
    if case.qtype == "qem":
        assert cp.check_qem_step(case) == 0
    else:
        assert cp.check_gradients(case, "vi") == 0


def test_radon_predictive_ll_matches_jax():
    cp.check_predictive_ll(cp.case("radon", "qem"))


def test_own_fake_data_at_published_sizes(case):
    cp.check_own_data(case)


def test_chimpanzees_real_data_loader(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {f"{stem}_{part}": (rng.random((7, 6, n)) < 0.5).astype(np.float32)
              for stem in ("condition", "prosoc_left", "data")
              for part, n in (("train", 10), ("test", 2))}
    cp.check_real_data_loader("chimpanzees", arrays, tmp_path)
