"""The port's FLOP accounting (``alan_tpu_torch/perf.py``) against
``alan_tpu.perf``, on the CPU.

* ``analytic_flops`` equals ``alan_tpu``'s exactly (both are shape
  arithmetic, counted at the same ops): the chain of
  ``tests/test_ops.py:306-320``, one QEM step of ``tests/test_sharding.py``'s
  tiny problem, one QEM step of its covid-shaped problem (R=2, T=8), and one
  QEM step of a small grouped MovieLens with the lazy low-rank route forced
  by the knobs both packages read;
* a VI step counts the same under ``checkpoint`` as under
  ``no_checkpoint`` (the backward's re-run of the forward counts nothing);
* ``op_cost`` (``FlopCounterMode``) is positive and no more than the
  analytic count;
* the peak table and ``counting_active()``.

``alan_tpu``'s count traces its step under ``jax.eval_shape``; the port's
runs the step once.  ``alan_tpu``'s problems are built with XLA's
optimisations off (``canonical_parity.quick_compiles``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alan_tpu import perf as jperf
from alan_tpu import train as jtrain
from alan_tpu.ops.logmmexp import chain_logmmexp as jchain
from alan_tpu_torch import checkpoint, no_checkpoint, perf, train
from alan_tpu_torch.ops.logmmexp import chain_logmmexp
from alan_tpu_torch.utils import seeded_generator
from canonical_parity import quick_compiles
from test_sharding import _covid_shaped_problem, _tiny_problem
from test_torch_parallel import covid_shaped, tiny
from test_torch_harness import Env, jax_movielens, port_movielens

#: the lazy low-rank route forced in both packages
LAZY = dict(ALAN_TPU_LOWRANK_MIN=1, ALAN_TPU_LAZY_LOWRANK=1,
            ALAN_TPU_LAZY_LOWRANK_INTERPRET=1)


def _grouped_arrays():
    from alan_tpu_torch.models import movielens as tml
    return tml.fake_data(seed=3, M=12, N=3)


def _qem_counts(jprob, tprob, K):
    jstep, jstate = jtrain.qem(jprob, K, lr=0.1)
    want = jperf.analytic_flops(jstep, (jstate, jax.random.key(0)))
    tstep, tstate = train.qem(tprob, K, lr=0.1, device="cpu")
    got = perf.analytic_flops(tstep, (tstate, seeded_generator(0, "cpu")))
    return got, want


def _same(got, want):
    for k in ("flops", "matmul_flops", "elementwise_flops", "grad_multiplier"):
        assert got[k] == want[k], (k, got[k], want[k])


def test_chain_counts_match_jax():
    """``tests/test_ops.py:306-320``: T-1 products of 2 B K^3, x3 with a
    gradient; the port's count is ``alan_tpu``'s."""
    B, T, K = 4, 8, 6
    ms = np.random.default_rng(0).standard_normal((B, T, K, K)).astype(np.float32)
    want = 2.0 * B * K ** 3 * (T - 1)
    for grad in (False, True):
        f = (lambda m: jnp.sum(jchain(m))) if grad else jchain
        j = jperf.analytic_flops(f, (jnp.asarray(ms),), grad=grad)
        tms = torch.tensor(ms, requires_grad=grad)
        g = (lambda m: chain_logmmexp(m).sum().backward()) if grad else chain_logmmexp
        t = perf.analytic_flops(g, (tms,), grad=grad)
        _same(t, j)
        assert t["matmul_flops"] == (3 if grad else 1) * want
    assert not perf.counting_active()


@pytest.mark.parametrize("case", ["tiny", "covid_shaped", "grouped_movielens_lazy"])
def test_qem_step_counts_match_jax(case):
    if case == "tiny":
        with quick_compiles():
            jprob = _tiny_problem()
        got, want = _qem_counts(jprob, tiny(), 8)
    elif case == "covid_shaped":
        with quick_compiles():
            jprob = _covid_shaped_problem(R=2, T=8)
        got, want = _qem_counts(jprob, covid_shaped(2, 8), 4)
    else:
        arrays = _grouped_arrays()
        with Env(**LAZY):
            with quick_compiles():
                jprob = jax_movielens(arrays)
            got, want = _qem_counts(jprob, port_movielens(arrays), 6)
            assert got["matmul_flops"] > 0
    _same(got, want)
    assert got["flops"] > 0


def test_checkpoint_counts_the_forward_once():
    """Under ``checkpoint`` the backward runs each plate body again; the
    hooks skip it, so a VI step counts what it counts under
    ``no_checkpoint``, and what ``alan_tpu``'s does (whose remat re-runs no
    Python)."""
    counts = {}
    for name, strategy in (("no_checkpoint", no_checkpoint), ("checkpoint", checkpoint)):
        step, state = train.vi(covid_shaped(2, 8, "opt"), 4, lr=0.01, device="cpu",
                               computation_strategy=strategy)
        counts[name] = perf.analytic_flops(step, (state, seeded_generator(1, "cpu")))
    _same(counts["checkpoint"], counts["no_checkpoint"])
    from alan_tpu import checkpoint as jcheckpoint
    with quick_compiles():
        jprob = _covid_shaped_problem(R=2, T=8, param="opt")
    jstep, jstate = jtrain.vi(jprob, 4, lr=0.01, computation_strategy=jcheckpoint)
    _same(counts["checkpoint"], jperf.analytic_flops(jstep, (jstate, jax.random.key(1))))


def test_op_cost_is_a_lower_bound():
    arrays = _grouped_arrays()
    with Env(**LAZY):
        step, state = train.qem(port_movielens(arrays), 6, lr=0.1, device="cpu")
        cost = perf.op_cost(step, state, seeded_generator(0, "cpu"))
        ana = perf.analytic_flops(step, (state, seeded_generator(0, "cpu")))
    assert 0 < cost["flops"] <= ana["flops"]
    assert set(cost) == {"flops"}


def test_mfu_report_on_the_cpu():
    """Without a card there is no peak: the counts are there, every share
    is None, and no byte key is invented."""
    step, state = train.qem(tiny(), 8, lr=0.1, device="cpu")
    rep = perf.mfu_report(step, (state, seeded_generator(0, "cpu")), 0.01, device="cpu")
    assert rep["device_kind"] == "cpu" and rep["power_limit"] is None
    assert rep["flops_per_step_analytic"] > 0
    assert rep["mfu"] is None and rep["mfu_analytic"] is None
    assert rep["fp32_share"] is None and rep["peak_flops_per_s"] is None
    assert not any("bytes" in k for k in rep)


@pytest.mark.parametrize("name,tf32", [("NVIDIA H100 80GB HBM3", 494.7e12),
                                       ("NVIDIA H100 PCIe", 378e12),
                                       ("NVIDIA H100 NVL", 417.5e12)])
def test_peak_table(name, tf32):
    p = perf.peaks_for_name(name)
    assert p["tf32"] == tf32
    assert p["fp32"] < p["tf32"] < p["bf16"]
    assert perf.peaks_for_name("NVIDIA A100-SXM4-80GB") is None


def test_no_peak_on_the_cpu():
    assert perf.peak_flops("cpu") is None
    assert perf.peak_flops_fp32("cpu") is None
    assert perf.hbm_bandwidth("cpu") is None
    assert perf.power_limit("cpu") is None


def test_counting_is_scoped():
    assert not perf.counting_active()
    seen = []
    perf.analytic_flops(lambda: seen.append(perf.counting_active()), (), grad=False)
    assert seen == [True]
    assert not perf.counting_active()
    # a count outside analytic_flops records nothing
    perf.count_flops(matmul=1.0)
    assert perf.analytic_flops(lambda: None, (), grad=False)["flops"] == 0.0
