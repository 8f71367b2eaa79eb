"""The quality experiments (``alan_tpu_torch/experiments/``) against the JAX
package's experiment scripts under ``scripts/``, on the CPU.

* the covid recipe's counts are bitwise those of
  ``scripts/moments_vs_hmc_covid.build_problem``;
* the z metric equals ``scripts/covid_smc_particle_trend.zstats`` and the
  K sweep's per-variable arithmetic (``covid_k_sweep._moment_table``) on
  the same numpy draws;
* the FFBS sweep's Kalman posteriors equal ``scripts/ffbs_coupling_sweep
  .build``'s, and a small estimate of each FFBS route lands near them;
* the occupancy coverage and the full-size run's latent residuals equal
  the JAX scripts' arithmetic on injected moments;
* every entry point, at a tiny size on ``--device cpu``, writes a record
  whose key paths include the matching JAX record's in ``results/``;
* no module of the experiments imports JAX or ``alan_tpu``.
"""
import ast
import glob
import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alan_tpu_torch.dims import DT as TDT
from alan_tpu_torch.experiments import (covid_corrq_probe, covid_full_qem_quality,
                                        covid_k_sweep, covid_smc_particle_trend,
                                        ffbs_coupling_sweep, latent_recovery,
                                        moments_vs_hmc_covid, occupancy_collapse_probe)
from alan_tpu_torch.experiments import covid_recipe as cr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
sys.path.insert(0, os.path.join(REPO, "examples", "models"))
RESULTS = os.path.join(REPO, "results")


class _Gold:
    """The JAX scripts' face of a draw array (``covid_k_sweep._Gold``)."""

    def __init__(self, data):
        self.data = data


def test_recipe_counts_bitwise_the_jax_script():
    import moments_vs_hmc_covid as jm
    from canonical_parity import quick_compiles
    with quick_compiles():
        want = np.asarray(jm.build_problem(3, 10, seed=0)._data["obs"].data)
    _, _, data, _ = cr.recipe(3, 10, seed=0, device="cpu")
    got = data["obs"]
    assert got.dims == ("nRs", "nDs")
    np.testing.assert_array_equal(got.data.numpy(), want)
    assert got.data.dtype == torch.float32 and want.dtype == np.float32


def _draws(seed):
    rng = np.random.default_rng(seed)
    gold = {"a": rng.standard_normal((40, 4, 3)) + 2.0,
            "b": 0.01 * rng.standard_normal((40, 4)),           # the floor binds
            "c": rng.standard_normal((40, 4, 2, 5)),
            "d": rng.standard_normal((40, 4, 6))}               # shape differs
    samples = {"a": rng.standard_normal((64, 3)) + 2.1,
               "b": 0.01 * rng.standard_normal((64,)),
               "c": rng.standard_normal((64, 2, 5)),
               "d": rng.standard_normal((64, 5)),
               "e": rng.standard_normal((64, 2))}               # no gold
    return gold, samples


def test_zstats_equal_the_jax_script():
    from covid_smc_particle_trend import zstats
    gold, samples = _draws(0)
    want = zstats({k: _Gold(v) for k, v in samples.items()},
                  {k: _Gold(v) for k, v in gold.items()})
    got = cr.zstats(samples, gold)
    assert set(got) == set(want) and set(got["variables"]) == set(want["variables"]) \
        == {"a", "b", "c"}
    assert got["n_coords"] == want["n_coords"]
    for k in ("z_median", "frac_z_lt_5"):
        assert abs(got[k] - want[k]) <= 1e-12
        for v in want["variables"]:
            assert abs(got["variables"][v][k] - want["variables"][v][k]) <= 1e-12


def test_sweep_entry_equals_the_jax_moment_table():
    from alan_tpu import mean
    from alan_tpu.dims import DT
    from covid_k_sweep import _moment_table
    gold, samples = _draws(1)
    means = {k: v.mean(axis=0).astype(np.float32) for k, v in samples.items()}
    dims = {"a": (), "b": (), "c": ("r",), "d": (), "e": ()}

    class Marg:
        def _moments(self, name, moment):
            assert moment is mean
            return DT(jnp.asarray(means[name]), dims[name])
    tab = _moment_table(Marg(), {k: _Gold(v) for k, v in gold.items()}, mean)
    got = cr.sweep_entry(gold, means)
    assert set(got["variables"]) == set(tab)
    for name, (mp, gm, stderr) in tab.items():
        z = np.abs(mp - gm) / stderr
        want = {"mse": float(np.mean((mp - gm) ** 2)), "z_median": float(np.median(z)),
                "z_max": float(z.max()), "frac_z_lt_5": float(np.mean(z < 5.0))}
        for k, w in want.items():
            assert abs(got["variables"][name][k] - w) <= 1e-12 * max(1.0, abs(w))


@pytest.mark.parametrize("c", [0.1, 1.0])
def test_ffbs_sweep_kalman_posteriors_equal_the_jax_script(c):
    import ffbs_coupling_sweep as jf
    jprob, j1, j2 = jf.build(c)
    prob, p1, p2 = ffbs_coupling_sweep.build(c, device="cpu")
    np.testing.assert_allclose(p1, j1, rtol=0, atol=1e-6)
    np.testing.assert_allclose(p2, j2, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(prob._data["obs"].data.numpy(),
                                  np.asarray(jprob._data["obs"].data))


def test_ffbs_sweep_small_estimates_near_the_kalman_mean():
    prob, p1, p2 = ffbs_coupling_sweep.build(1.0, device="cpu")
    truth = np.stack([p1, p2])
    joint = ffbs_coupling_sweep.bias_record(
        *ffbs_coupling_sweep.estimate(prob, True, K=16, N=200, reps=8), truth)
    cond = ffbs_coupling_sweep.bias_record(
        *ffbs_coupling_sweep.estimate(prob, False, K=16, N=200, reps=8), truth)
    assert joint["max_bias_over_stderr"] <= 5.0, joint
    assert np.isfinite(cond["max_abs_bias"]) and "ALAN_TPU_FFBS_JOINT_MAX" not in os.environ


def _injected_moments(seed):
    """Latents over an extended plate p (7, train 5) and their means and
    second moments over the train plate."""
    rng = np.random.default_rng(seed)
    latents = {"g": (rng.standard_normal(3), ()),
               "x": (rng.standard_normal((7, 2)), ("p",)),
               "y": (rng.standard_normal((4, 7)), ("q", "p")),
               "z": (rng.random(7) < 0.5, ("p",))}
    m1 = {"g": (rng.standard_normal(3), ()), "x": (rng.standard_normal((5, 2)), ("p",)),
          "y": (rng.standard_normal((5, 4)), ("p", "q"))}
    m2 = {k: (m ** 2 + rng.random(m.shape) * 3, d) for k, (m, d) in m1.items()}
    m2["g"][0][0] = m1["g"][0][0] ** 2 - 1.0            # a negative variance: the clip
    return latents, m1, m2


def test_occupancy_coverage_equals_the_jax_script():
    import occupancy_collapse_probe as jo
    from alan_tpu import mean
    from alan_tpu.dims import DT
    latents, m1, m2 = _injected_moments(3)
    f32 = lambda a: np.asarray(a, np.float32)

    class JMarg:
        def _moments(self, names, moment):
            a, d = (m1 if moment is mean else m2)[names[0]]
            return DT(jnp.asarray(f32(a)), d)
    jprob = types.SimpleNamespace(all_platedims={"p": 5, "q": 4}, sample=lambda *a, **k:
                                  types.SimpleNamespace(marginals=lambda: JMarg()))
    want = jo.coverage(jprob, {k: DT(jnp.asarray(f32(a)), d) for k, (a, d) in latents.items()},
                       3, None)

    class TMarg:
        def moments(self, names, moment):
            from alan_tpu_torch.moments import mean as tmean
            a, d = (m1 if moment is tmean else m2)[names[0]]
            return TDT(torch.as_tensor(f32(a)), d)
    tprob = types.SimpleNamespace(all_platedims={"p": 5, "q": 4})
    got = occupancy_collapse_probe.coverage_of(occupancy_collapse_probe.coverage_arrays(
        tprob, {k: TDT(torch.as_tensor(f32(a)), d) for k, (a, d) in latents.items()},
        TMarg()))
    assert got[0] == want[0] and got[1] == want[1]
    assert abs(got[2] - want[2]) <= 1e-6 * abs(want[2])


def test_latent_residuals_equal_the_jax_script_arithmetic():
    from alan_tpu.dims import DT, as_dt
    latents, m1, m2 = _injected_moments(4)
    f32 = lambda a: np.asarray(a, np.float32)
    truth = {k: latents[k] for k in ("x", "y")}
    means = {}
    for k in truth:
        means[f"{k}_mean"], means[f"{k}_mean2"] = m1[k], m2[k]
    # ``scripts/covid_full_qem_quality.py:141-165`` on JAX DTs
    want = {}
    for name, (arr, dims) in truth.items():
        m, mm2 = (as_dt(DT(jnp.asarray(f32(a)), d)) for a, d in (m1[name], m2[name]))
        ta = np.asarray(as_dt(DT(jnp.asarray(f32(arr)), dims)).with_dims_front(m.dims).data)
        ma = np.asarray(m.data)
        va = np.asarray(mm2.data) - ma ** 2
        if ta.shape != ma.shape:
            ta = ta[tuple(slice(0, d) for d in ma.shape)]
        z = (ma - ta) / np.sqrt(np.maximum(va, 1e-12))
        want[name] = {"frac_within_5std": float(np.mean(np.abs(z) < 5)),
                      "z_median_abs": float(np.median(np.abs(z))), "n": int(z.size)}
    got = covid_full_qem_quality.latent_recovery(
        {k: TDT(torch.as_tensor(f32(a)), d) for k, (a, d) in means.items()},
        {k: (f32(a), d) for k, (a, d) in truth.items()})
    assert got.keys() == want.keys()
    for name in want:
        assert got[name]["n"] == want[name]["n"]
        assert got[name]["frac_within_5std"] == want[name]["frac_within_5std"]
        assert abs(got[name]["z_median_abs"] - want[name]["z_median_abs"]) <= 1e-5


def _paths(x, p=()):
    """A record's key paths, numeric keys (K, particles) and seed numbers
    as placeholders, list entries merged."""
    if isinstance(x, dict):
        out = {p}
        for k, v in x.items():
            k = "<n>" if k.replace(".", "").isdigit() else (
                "seed<n>" if k.startswith("seed") and k[4:].isdigit() else k)
            out |= _paths(v, p + (k,))
        return out
    if isinstance(x, list) and x and isinstance(x[0], dict):
        return {p}.union(*(_paths(v, p + ("[]",)) for v in x))
    return {p}


def _jax_paths(name):
    with open(os.path.join(RESULTS, f"{name}.json")) as fh:
        return _paths(json.load(fh))


def _record(out, name):
    with open(os.path.join(out, name)) as fh:
        return json.load(fh)


def test_entry_points_write_the_jax_records_keys(tmp_path):
    out = str(tmp_path)
    common = ["--device", "cpu", "--out-dir", out]
    gold = ["--nRs", "2", "--nDs", "5", "--draws", "6", "--warmup", "6", "--max-depth", "3"]
    moments_vs_hmc_covid.main(common + gold + ["--K", "3", "--iters", "3"])
    covid_k_sweep.main(common + gold + ["--Ks", "3", "4", "--iters", "3",
                                        "--smc-particles", "64"])
    covid_smc_particle_trend.main(["32", "64"] + common + gold)
    covid_corrq_probe.main(common + gold + ["--Ks", "3", "--iters", "2"])
    covid_full_qem_quality.main(common + ["--seeds", "0", "1", "--nRs", "2", "--nDs", "6",
                                          "--K", "3", "--seg", "2", "--segments", "2",
                                          "--N", "4"])
    ffbs_coupling_sweep.main(common + ["--couplings", "0.1", "1.0", "--N", "50",
                                       "--reps", "2"])
    occupancy_collapse_probe.main(common + ["--K", "2", "--iters", "1"])
    latent_recovery.run(models=("radon", "covid", "bus_breakdown"), K_=2, iters=1,
                        device="cpu", out_dir=out)
    for name in ("moments_vs_hmc_covid", "covid_k_sweep", "moments_vs_smc_covid",
                 "covid_full_qem_quality", "ffbs_coupling_sweep", "occupancy_collapse_probe"):
        missing = _jax_paths(name) - _paths(_record(out, f"{name}.json"))
        assert not missing, (name, sorted(missing)[:10])
    corrq = _record(out, "covid_corrq_probe.json")
    assert {"model", "iters", "nuts_time_s", "factorised_control_note", "arms"} <= set(corrq)
    assert set(corrq["arms"]) == {"corr_Q_K3", "factorised_K3"}
    for arm in corrq["arms"].values():
        assert {"mp_time_s", "variables", "overall"} <= set(arm)
        assert all(set(v) == {"z_median", "z_max", "mse"} for v in arm["variables"].values())
        assert set(arm["overall"]) == {"z_median", "frac_z_lt_5"}
    lr = _record(out, "latent_recovery.json")
    assert set(lr["test_qem_recovers_generating_latents"]) == {"radon", "covid", "bus_breakdown"}
    assert set(lr["test_training_improves_predictive_ll"]) == {"bus_breakdown"}
    assert lr["test_double_timeseries_extend_predictive"]["ok"]
    assert set(os.listdir(out)) == {f"{n}.json" for n in (
        "moments_vs_hmc_covid", "covid_k_sweep", "moments_vs_smc_covid", "covid_corrq_probe",
        "covid_full_qem_quality", "ffbs_coupling_sweep", "occupancy_collapse_probe",
        "latent_recovery", "covid_nuts_gold_meta")} | {"covid_nuts_gold.npz"}


def test_entry_points_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(Exception):
        moments_vs_hmc_covid.main([])


def test_no_experiment_imports_jax_or_alan_tpu():
    for path in glob.glob(os.path.join(REPO, "alan_tpu_torch", "experiments", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "alan_tpu", "scripts", "examples"), \
                    (path, n)


def test_occupancy_fixture_is_the_jax_tests_data():
    from occupancy_fixture import jax_arrays
    z = np.load(latent_recovery.OCCUPANCY_JAX_TEST_DATA)
    dims = json.loads(str(z["dims"]))
    want = jax_arrays()
    assert set(want) == set(dims) == set(z.files) - {"dims"}
    for k, (a, d) in want.items():
        assert tuple(dims[k]) == d
        np.testing.assert_array_equal(z[k], a)
    problem, *_, latents = latent_recovery.occupancy_jax_test_data("cpu")
    assert set(latents) == set(want) - {"obs", "weather", "quality"}
    assert problem.all_platedims["plate_Ids"] == 200
