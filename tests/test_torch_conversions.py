"""The port's QEM conversions (``alan_tpu_torch/conversions.py``) against
``alan_tpu``'s.

* ``conversion_dict`` has ``alan_tpu``'s ten families.
* ``conv2mean``, ``mean2conv`` and ``canonical_conv`` of every conversion on
  the same numpy inputs, over a named dim: 1e-5 relative (atol 1e-6), the
  Gamma's Newton solve and the Dirichlet's and Beta's digamma inversions
  1e-4; ``inverse_digamma`` and ``grad_digamma`` alone, 1e-4 and 1e-5.
* A round trip: ``mean2conv(conv2mean(p))`` gives ``p`` back.
* One QEM update of a Gamma, a Dirichlet and a MultivariateNormal latent from
  ``alan_tpu``'s particles: ELBO 1e-5 relative, the updated QEM state
  within rtol/atol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alan_tpu.conversions as JC
from alan_tpu.sample import Sample as JSample
from alan_tpu.sampler import PermutationSampler as JPerm
from alan_tpu.split import no_checkpoint as j_no_checkpoint
import alan_tpu_torch.conversions as TC
from alan_tpu_torch import convert, train
from test_torch_harness import assert_dt_close, assert_tree_close, jax_dt, to_numpy_tree

RNG = np.random.default_rng(0)
_A = RNG.standard_normal((4, 3, 3))
_COVS = (_A @ np.swapaxes(_A, -1, -2) + np.eye(3)).astype(np.float32)


def _pos(*shape, s=1.0, off=0.3):
    return (np.abs(RNG.standard_normal(shape)) * s + off).astype(np.float32)


#: family name -> conventional params (arrays over a leading dim "k")
CONV_PARAMS = {
    "Bernoulli": {"probs": RNG.uniform(0.05, 0.95, 4).astype(np.float32)},
    "ContinuousBernoulli": {"probs": RNG.uniform(0.05, 0.95, 4).astype(np.float32)},
    "Beta": {"concentration1": _pos(4, s=2.0), "concentration0": _pos(4, s=2.0)},
    "Dirichlet": {"concentration": _pos(4, 3, s=2.0)},
    "Poisson": {"rate": _pos(4, s=3.0)},
    "Exponential": {"rate": _pos(4)},
    "Normal": {"loc": RNG.standard_normal(4).astype(np.float32), "scale": _pos(4)},
    "Gamma": {"concentration": _pos(4, s=3.0, off=0.5), "rate": _pos(4)},
    "MultivariateNormal": {"loc": RNG.standard_normal((4, 3)).astype(np.float32),
                           "covariance_matrix": _COVS},
    "HalfNormal": {"scale": _pos(4)},
}
#: the Newton solves and digamma inversions: 1e-4
ITERATIVE = {"Beta", "Dirichlet", "Gamma"}


def _conv(mod, name):
    (cls,) = [c for f, c in mod.conversion_dict.items() if f.name == name]
    return cls


def _both(params):
    j = {k: jax_dt(v, "k") for k, v in params.items()}
    t = {k: convert.dt_from_numpy(v, ("k",), "cpu") for k, v in params.items()}
    return j, t


def test_conversion_dict_has_alan_tpus_families():
    assert sorted(f.name for f in TC.conversion_dict) == \
        sorted(f.name for f in JC.conversion_dict) == sorted(CONV_PARAMS)
    for f, c in TC.conversion_dict.items():
        jc = _conv(JC, f.name)
        assert c.family is f
        assert [m.name for m in c.sufficient_stats] == [m.name for m in jc.sufficient_stats]


@pytest.mark.parametrize("name", list(CONV_PARAMS))
def test_conversion_matches_jax(name):
    jc, tc = _conv(JC, name), _conv(TC, name)
    tol = 1e-4 if name in ITERATIVE else 1e-5
    jp, tp = _both(CONV_PARAMS[name])
    jm, tm = jc.conv2mean(**jp), tc.conv2mean(**tp)
    assert len(jm) == len(tm) == len(tc.sufficient_stats)
    for a, b in zip(jm, tm):
        assert_dt_close(a, b, 1e-5, 1e-6)
    # mean2conv of the same means, and back to the params
    jmeans = [jax_dt(np.asarray(m.data), *m.dims) for m in jm]
    tmeans = [convert.dt_from_numpy(np.asarray(m.data), m.dims, "cpu") for m in jm]
    jback, tback = jc.mean2conv(*jmeans), tc.mean2conv(*tmeans)
    assert set(jback) == set(tback)
    for k in jback:
        assert_dt_close(jback[k], tback[k], tol, 1e-6)
        got = tback[k].with_dims_front(["k"]).data.numpy()
        np.testing.assert_allclose(got, CONV_PARAMS[name][k], rtol=1e-3, atol=1e-4)
    jcan, tcan = jc.canonical_conv(**jp), tc.canonical_conv(**tp)
    assert set(jcan) == set(tcan)
    for k in jcan:
        assert_dt_close(jax_dt(np.asarray(jcan[k].data), *jcan[k].dims), tcan[k], 1e-5, 1e-6)


def test_canonical_conv_alternatives_match_jax():
    """The Bernoulli from logits; the MultivariateNormal from a precision
    matrix or a ``scale_tril``."""
    logits = RNG.standard_normal(4).astype(np.float32)
    j, t = _both({"logits": logits})
    assert_dt_close(JC.BernoulliConversion.canonical_conv(**j)["probs"],
                    TC.BernoulliConversion.canonical_conv(**t)["probs"], 1e-5, 1e-6)
    loc = RNG.standard_normal((4, 3)).astype(np.float32)
    for key, m in (("precision_matrix", np.linalg.inv(_COVS).astype(np.float32)),
                   ("scale_tril", np.linalg.cholesky(_COVS).astype(np.float32))):
        j, t = _both({"loc": loc, key: m})
        jc = JC.MultivariateNormalConversion.canonical_conv(**j)
        tc = TC.MultivariateNormalConversion.canonical_conv(**t)
        assert_dt_close(jc["covariance_matrix"], tc["covariance_matrix"], 1e-4, 1e-5)
        np.testing.assert_allclose(tc["covariance_matrix"].with_dims_front(["k"]).data.numpy(),
                                   _COVS, rtol=1e-4, atol=1e-4)


def test_digamma_helpers_match_jax():
    y = np.linspace(-6.0, 4.0, 41).astype(np.float32)
    j = JC.inverse_digamma(jax_dt(y, "k"))
    t = TC.inverse_digamma(convert.dt_from_numpy(y, ("k",), "cpu"))
    assert_dt_close(j, t, 1e-4, 1e-6)
    np.testing.assert_allclose(torch.digamma(t.data).numpy(), y, rtol=1e-4, atol=1e-4)
    x = _pos(20, s=3.0)
    assert_dt_close(JC.grad_digamma(jax_dt(x, "k")),
                    TC.grad_digamma(convert.dt_from_numpy(x, ("k",), "cpu")), 1e-5, 1e-6)


# ---- one QEM update -------------------------------------------------------------------

def _models(name):
    """(P, Q, data) of a small conjugate model in each package, a QEM Q."""
    import alan_tpu as J
    import alan_tpu_torch as T
    counts = np.array([3, 5, 2, 4, 6, 3, 1, 4], np.float32)
    cats = np.array([0, 2, 2, 1, 0, 2, 2, 1], np.float32)
    obs = RNG.standard_normal((8, 3)).astype(np.float32) + 1.0
    out = []
    for pkg, arr, nm in ((J, jnp.asarray, J.named),
                         (T, torch.tensor, T.named)):
        if name == "Gamma":
            P = pkg.Plate(a=pkg.Gamma(2.0, 1.0), T=pkg.Plate(d=pkg.Poisson("a")))
            Q = pkg.Plate(a=pkg.Gamma(pkg.QEMParam(2.0), pkg.QEMParam(1.0)),
                          T=pkg.Plate(d=pkg.Data()))
            data = counts
        elif name == "Dirichlet":
            P = pkg.Plate(a=pkg.Dirichlet(arr(np.ones(3, np.float32))),
                          T=pkg.Plate(d=pkg.Categorical("a")))
            Q = pkg.Plate(a=pkg.Dirichlet(pkg.QEMParam(arr(np.full(3, 1.5, np.float32)))),
                          T=pkg.Plate(d=pkg.Data()))
            data = cats
        else:
            P = pkg.Plate(a=pkg.MultivariateNormal(arr(np.zeros(3, np.float32)),
                                                   arr(np.eye(3, dtype=np.float32))),
                          T=pkg.Plate(d=pkg.MultivariateNormal("a", arr(_COVS[0]))))
            Q = pkg.Plate(a=pkg.MultivariateNormal(
                pkg.QEMParam(arr(np.zeros(3, np.float32))),
                covariance_matrix=pkg.QEMParam(arr(2.0 * np.eye(3, dtype=np.float32)))),
                T=pkg.Plate(d=pkg.Data()))
            data = obs
        kw = {} if pkg is J else {"device": "cpu"}
        ps = {"T": 8}
        out.append(pkg.Problem(pkg.BoundPlate(P, ps, **kw), pkg.BoundPlate(Q, ps, **kw),
                               {"d": nm(arr(data), "T")}, **kw))
    return out


@pytest.mark.parametrize("name", ["Gamma", "Dirichlet", "MultivariateNormal"])
def test_qem_update_matches_jax(name):
    K, lr = 30, 0.4
    jprob, tprob = _models(name)
    jtree, _ = jprob.Q._sample(K, False, JPerm, jprob.all_platedims, jax.random.key(2))
    stP, stQ = jprob.P.state(), jprob.Q.state()
    s = JSample(jprob, jtree, jprob.Q.plate.groupvarname2Kdim(K), JPerm, False,
                states=(stP, stQ))
    j_elbo, j_moms = s._moments_and_elbo(list(jprob.Q.qem_flat_list_rmkeys), j_no_checkpoint)
    j_newQ = jprob.Q._updated_qem_state(lr, s, j_no_checkpoint, state=stQ, moments=j_moms)

    carried = convert.state_from_numpy(to_numpy_tree(stQ), "cpu")
    assert_tree_close(stQ["qem_params"], carried["qem_params"], 0, 0)
    assert_tree_close(stQ["qem_means"], tprob.Q.state()["qem_means"], 1e-5, 1e-6)
    tree = convert.tree_from_numpy(to_numpy_tree(jtree), "cpu")
    step, state = train.qem(tprob, K, lr=lr, device="cpu")
    (_, t_newQ), t_elbo = step(state, sample=tree)
    assert abs(float(t_elbo) - float(j_elbo)) <= 1e-5 * abs(float(j_elbo))
    assert_tree_close(j_newQ["qem_means"], t_newQ["qem_means"], 1e-4, 1e-4)
    assert_tree_close(j_newQ["qem_params"], t_newQ["qem_params"], 1e-4, 1e-4)
    for v in t_newQ["qem_params"].values():
        assert torch.isfinite(v.data).all()
