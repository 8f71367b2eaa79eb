"""The port's simple examples (``alan_tpu_torch/simple_examples/``, the
counterparts of ``examples/simple_examples/``) and ``basic_runner`` run
to their end on the CPU through the public API (``--device cpu``), as
``tests/test_examples.py`` runs the JAX examples.  In ``moment_example``
the source-term moments and the marginals' agree to 1e-5."""
import importlib
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "examples", "simple_examples"))
                  if f.endswith(".py"))


def test_every_example_has_a_counterpart():
    port = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "alan_tpu_torch",
                                                          "simple_examples"))
                  if f.endswith(".py") and f != "__init__.py")
    assert port == EXAMPLES and len(EXAMPLES) == 8


@pytest.mark.parametrize("name", EXAMPLES)
def test_simple_example_runs(name, capsys):
    mod = importlib.import_module(f"alan_tpu_torch.simple_examples.{name}")
    out = mod.main(["--device", "cpu"])
    assert capsys.readouterr().out
    if name == "moment_example":
        from_sample, from_marginals = out
        for vn in ("a", "b", "c", "d"):
            np.testing.assert_allclose(from_sample[vn].data.numpy(),
                                       from_marginals[vn].data.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=vn)
    elif name == "simple_elbo_experiment":
        assert out[1] < out[10] < out[100]
    elif name in ("example", "linear_gaussian", "linear_gaussian_plated",
                  "predictive_example"):
        assert all(np.isfinite(float(v.data)) for v in out.values())
    elif name == "timeseries":
        assert np.all(np.isfinite(out))


def test_the_examples_refuse_the_card_without_one():
    from alan_tpu_torch.simple_examples import linear_gaussian
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        linear_gaussian.main([])


def test_basic_runner(capsys):
    from alan_tpu_torch import basic_runner
    res = basic_runner.run("movielens", methods=["qem", "vi", "rws", "global_qem"], K=3,
                           num_iters=3, device="cpu")
    assert set(res) == {("movielens", m, 0) for m in ("qem", "vi", "rws", "global_qem")}
    assert all(len(e) == 3 and torch.isfinite(e).all() for e in res.values())
    assert capsys.readouterr().out.count("movielens/") == 4
    res = basic_runner.main(["radon", "--device", "cpu"])
    assert len(res[("radon", "qem", 0)]) == 50
