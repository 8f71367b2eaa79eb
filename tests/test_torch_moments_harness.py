"""The moment-accuracy harnesses (``alan_tpu_torch/runner_moments.py``,
``alan_tpu_torch/runner_moments_IS.py``) and the models' fake latents, on
the CPU.

* ``moment_record`` equals ``examples/runner_moments.py``'s ``moment_mse``,
  and ``sweep_record`` (with ``_truth``'s slicing) the IS sweep's record of
  ``examples/runner_moments_IS.py``, on the same numpy gold draws and
  estimates: the JAX harness runs with its sampler, fit, sample and model
  replaced inside the test by stand-ins that hand it those arrays;
* on ``tests/model_linear_gaussian.py``'s model the gold (HMC) and MP
  means lie within 6 standard errors of the analytic posterior mean;
* ``return_fake_latents`` returns the latents the data were drawn from, at
  ``alan_tpu``'s dims and sizes;
* both CLIs write records with the JAX harnesses' keys.
"""
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alan_tpu_torch import BoundPlate, Data, Normal, Plate, Problem, QEMParam, named
from alan_tpu_torch import runner_moments, runner_moments_IS
from alan_tpu_torch.dims import DT as TDT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))
sys.path.insert(0, os.path.join(REPO, "examples", "models"))

JAX_RECORD_KEYS = {"model", "K", "iters", "hmc_time_s", "mp_time_s", "hmc_diag",
                   "moment_mse"}
JAX_SWEEP_KEYS = {"run_s", "var_mse", "fake_mse", "var_mse_total", "fake_mse_total"}


def _install_model(monkeypatch, name, problem, extra=()):
    mod = types.ModuleType(name)
    mod.load_and_generate_problem = lambda **kw: (problem, None, None, None, *extra)
    monkeypatch.setitem(sys.modules, name, mod)


def test_moment_record_equals_the_jax_harness(monkeypatch):
    import runner_moments as jrm
    import alan_tpu.mcmc
    import alan_tpu.train
    from alan_tpu.dims import DT
    rng = np.random.default_rng(1)
    gold = {"mu": rng.standard_normal((50, 4, 3)).astype(np.float32),
            "z": rng.standard_normal((50, 4, 7, 3)).astype(np.float32),
            "w": rng.standard_normal((50, 4, 5)).astype(np.float32),   # MP shape differs
            "v": rng.standard_normal((50, 4)).astype(np.float32)}      # no MP moment
    mp = {"mu": rng.standard_normal(3).astype(np.float32),
          "z": rng.standard_normal((7, 3)).astype(np.float32),
          "w": rng.standard_normal(6).astype(np.float32)}
    plates = {"mu": (), "z": ("plate_1",), "w": (), "v": ()}

    class Marg:
        def _moments(self, name, moment):
            return DT(jnp.asarray(mp[name]), plates[name])   # KeyError for "v"

    problem = types.SimpleNamespace(_data={}, P=None,
                                    sample=lambda **kw: types.SimpleNamespace(
                                        marginals=lambda: Marg()))
    _install_model(monkeypatch, "injected_model", problem)
    monkeypatch.setattr(alan_tpu.mcmc, "run_hmc", lambda *a, **kw: (
        {k: DT(jnp.asarray(v), ("draw", "chain") + plates[k]) for k, v in gold.items()},
        {"mean_accept": 0.9}))
    monkeypatch.setattr(alan_tpu.train, "fit", lambda *a, **kw: None)
    want = jrm.run("injected_model", K=3, iters=1)
    got = runner_moments.moment_record(gold, mp)
    assert got == want["moment_mse"] and set(got) == {"mu", "z"}
    assert JAX_RECORD_KEYS == set(want)


def test_sweep_record_equals_the_jax_harness(monkeypatch):
    import runner_moments_IS as jis
    from alan_tpu.dims import DT
    runs, latents = 4, ["mu", "z", "w"]
    rng = np.random.default_rng(2)
    truth_full = {"mu": rng.standard_normal(3).astype(np.float32),
                  "z": rng.standard_normal((9, 3)).astype(np.float32),    # longer plate
                  "w": rng.standard_normal(2).astype(np.float32)}         # shape differs
    dims = {"mu": (), "z": ("plate_1",), "w": ()}
    shapes = {"mu": (3,), "z": (7, 3), "w": (5,)}
    ests = {(tag, K): [[rng.standard_normal(shapes[n]).astype(np.float32) for n in latents]
                       for _ in range(runs)]
            for tag, Ks in (("mp", (3, 10)), ("global_is", (100,))) for K in Ks}
    problem = types.SimpleNamespace(all_platedims={"plate_1": 7})
    _install_model(monkeypatch, "injected_model",
                   problem, ({k: DT(jnp.asarray(v), dims[k]) for k, v in truth_full.items()},))
    monkeypatch.setattr(jis, "_latent_moment_list", lambda p: (None, latents))

    def make(tag):
        def make_fn(problem, K, *args):
            it = iter(ests[tag, K])
            return lambda key: [jnp.asarray(x) for x in next(it)]
        return make_fn
    monkeypatch.setattr(jis, "make_mp_fn", make("mp"))
    monkeypatch.setattr(jis, "make_is_fn", make("global_is"))
    want = jis.sweep("injected_model", [3, 10], [100], runs=runs)

    port_problem = types.SimpleNamespace(all_platedims={"plate_1": 7})
    truth, tdims = runner_moments_IS._truth(
        port_problem, {k: TDT(torch.tensor(v), dims[k]) for k, v in truth_full.items()},
        latents)
    assert tdims == dims and truth["z"].shape == (7, 3)
    for (tag, K), e in ests.items():
        got = runner_moments_IS.sweep_record(e, truth, latents, runs, 0.0)
        w = want[tag][str(K)]
        assert JAX_SWEEP_KEYS == set(w)
        for key in JAX_SWEEP_KEYS - {"run_s"}:
            assert got[key] == w[key], (tag, K, key)
        assert set(got["fake_mse"]) == {"mu", "z"}


def test_is_chunk_is_the_reference_rounding():
    for K, chunk, want in ((1_000_000, 30000, 25000), (10_000, 30000, 10000),
                           (100, 30, 25), (97, 30, 1)):
        assert runner_moments_IS.is_chunk(K, chunk) == want


def _linear_gaussian():
    prior_mean, prior_scale, like_scale, mult, N = 2, 2, 3, 2.5, 10
    data_np = 1.5 + np.random.default_rng(0).standard_normal(N)
    post_prec = 1 / prior_scale ** 2 + N * mult ** 2 / like_scale ** 2
    post_mean = (prior_mean / prior_scale ** 2
                 + mult ** 2 / like_scale ** 2 * (data_np.sum() / mult)) / post_prec
    P = BoundPlate(Plate(a=Normal(prior_mean, prior_scale),
                         T=Plate(d=Normal(lambda a: mult * a, like_scale))), {"T": N},
                   device="cpu")
    Q = BoundPlate(Plate(a=Normal(QEMParam(1.), QEMParam(4.)), T=Plate(d=Data())), {"T": N},
                   device="cpu")
    data = {"d": named(torch.tensor(data_np, dtype=torch.float32), "T")}
    return Problem(P, Q, data, device="cpu"), post_mean, post_prec ** -0.5


def test_linear_gaussian_gold_and_mp_means_near_the_posterior():
    from alan_tpu_torch.diagnostics import ess_bulk
    problem, post_mean, post_sd = _linear_gaussian()
    gold, diag, dims = runner_moments.gold_draws(problem, "hmc", 200, 200, seed=0)
    a = gold["a"]
    se_gold = post_sd / np.sqrt(float(np.asarray(ess_bulk(a)).min()))
    assert abs(a.mean() - post_mean) < 6 * se_gold, (a.mean(), post_mean, se_gold)
    assert diag["mean_accept"] > 0.5 and "rhat_max_a" in diag
    marg = runner_moments.fit_mp(problem, K=300, iters=20, seed=0, device="cpu")
    mp = runner_moments.mp_means(marg, dims)
    ess = float(marg.min_ess())
    assert abs(float(mp["a"]) - post_mean) < 6 * post_sd / np.sqrt(ess), (mp, post_mean, ess)
    rec = runner_moments.moment_record(gold, mp)
    assert set(rec) == {"a"} and np.isfinite(rec["a"])


#: (model, alan_tpu's loader keywords, the port's)
FAKE = [("radon", {}, {}), ("chimpanzees", {}, {}), ("bus_breakdown", {}, {}),
        ("occupancy", {}, {}), ("movielens", {"M": 7, "N": 3}, None),
        ("covid", {"nRs": 3, "nDs": 8}, {"nRs": 3, "nDs": 8})]


@pytest.mark.parametrize("name,jkw,tkw", FAKE, ids=[f[0] for f in FAKE])
def test_fake_latents_at_alan_tpus_shapes(name, jkw, tkw):
    """The port's latents carry ``alan_tpu``'s names, dims and sizes (its
    draws differ: numpy's generator, not JAX's); with real data they are
    refused."""
    import importlib
    jmod = importlib.import_module(name)
    tmod = importlib.import_module(f"alan_tpu_torch.models.{name}")
    # shapes only: traced, neither compiled nor run
    jlat = jax.eval_shape(lambda key: jmod.load_data_covariates(
        key, return_fake_latents=True, **jkw)[-1], jax.random.key(0))
    if tkw is None:          # the port's MovieLens sizes go through load_train_all
        out = tmod.load_train_all(0, M=7, N=3, return_fake_latents=True, device="cpu")
    else:
        out = tmod.load_data_covariates(0, device="cpu", return_fake_latents=True, **tkw)
    tlat = out[-1]
    assert set(tlat) == set(jlat)
    for k, v in jlat.items():
        sizes = dict(zip(v.dims, v.data.shape))
        tsizes = dict(zip(tlat[k].dims, tlat[k].data.shape))
        assert tsizes == sizes and tlat[k].data.shape[len(tlat[k].dims):] == \
            v.data.shape[len(v.dims):], k
    with pytest.raises(ValueError, match="fake_data"):
        tmod.load_and_generate_problem(fake_data=False, return_fake_latents=True,
                                       device="cpu")


def test_fake_latents_are_the_generating_values():
    """Radon's and MovieLens's returned latents are the arrays their fake
    data came from."""
    from alan_tpu_torch.models import movielens, radon
    lat = radon.load_and_generate_problem(seed=3, return_fake_latents=True, device="cpu")[4]
    arrays = radon.fake_arrays(3)
    for k, v in lat.items():
        np.testing.assert_array_equal(v.data.numpy(), arrays[k])
    lat = movielens.load_and_generate_problem(seed=3, return_fake_latents=True,
                                              device="cpu")[4]
    arrays = movielens.fake_data(3)
    for k in ("mu_z", "psi_z", "z"):
        np.testing.assert_array_equal(lat[k].data.numpy(), arrays[k])


def test_clis_write_the_jax_keys(tmp_path, capsys):
    out = tmp_path / "m.json"
    runner_moments.main(["--model", "radon", "--K", "3", "--iters", "2", "--hmc-samples",
                         "20", "--sampler", "smc", "--device", "cpu",
                         "--out", str(out)])
    rec = json.loads(out.read_text())
    assert JAX_RECORD_KEYS <= set(rec) and set(rec["moment_mse"]) == {
        "global_mean", "global_log_sigma", "State_mean", "State_log_sigma", "Beta_u",
        "Beta_basement"}
    assert all(np.isfinite(v) for v in rec["moment_mse"].values())
    out = tmp_path / "is.json"
    runner_moments_IS.main(["--model", "radon", "--mp-Ks", "3", "--is-Ks", "60",
                            "--runs", "2", "--chunk", "25", "--device", "cpu",
                            "--out", str(out)])
    rec = json.loads(out.read_text())
    assert {"model", "runs", "latents", "chunk", "mp", "global_is"} <= set(rec)
    for tag, K in (("mp", "3"), ("global_is", "60")):
        r = rec[tag][K]
        assert JAX_SWEEP_KEYS <= set(r), r
        assert r["busy_s"] is None and r["idle_share"] is None
        assert np.isfinite(r["var_mse_total"]) and np.isfinite(r["fake_mse_total"])
        assert set(r["fake_mse"]) == set(rec["latents"])
    capsys.readouterr()
