"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card and ``nvcc`` and skips without them.
The file imports neither JAX nor ``alan_tpu``, so on a machine with a card
and no JAX it runs without the suite's conftest:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

* ``lowrank_logsumexp`` forward and all three gradients against
  ``reference_lowrank_logsumexp`` on the same CUDA tensors: rtol/atol 1e-5
  forward, rtol 1e-4 / atol 1e-5 gradients (the tolerances of
  ``tests/test_lowrank_lazy.py``);
* one grouped-MovieLens QEM step on the card (lazy path forced, so z's
  factor runs through the kernels) against the same step on the CPU (the
  plain version), from the same particles.
"""
import numpy as np
import pytest
import torch

from alan_tpu_torch import train
from alan_tpu_torch.dims import DT
from alan_tpu_torch.models import movielens as tml
from alan_tpu_torch.ops import lowrank as tlr
from alan_tpu_torch.ops import lowrank_kernel as tk
from alan_tpu_torch.sampler import PermutationSampler

pytestmark = pytest.mark.cuda

CASES = [
    ((1, 20, 300, 40, 6), False),    # single i-chunk
    ((2, 9, 1300, 130, 4), False),   # overhang on every axis
    ((1, 3, 50, 7, 36), False),      # tiny j, the main path's F
    ((1, 1, 257, 1, 2), False),      # degenerate plate/parent
    ((1, 4, 64, 5, 3), True),        # -inf bias rows
    ((2, 5, 130, 40, 41), False),    # F just past 40: two feature chunks
    ((1, 3, 70, 9, 80), False),      # F = 80: three feature chunks
    ((1, 70000, 3, 5, 2), False),    # P above a launch's grid.y limit
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return torch.device("cuda")


def _operands(shape, seed, inf_bias):
    S, P, I, J, F = shape
    rng = np.random.default_rng(seed)
    U = (rng.standard_normal((S, P, I, F)) * 0.5).astype(np.float32)
    V = (rng.standard_normal((S, J, F)) * 0.5).astype(np.float32)
    D = (rng.standard_normal((S, P, I)) * 2.0).astype(np.float32)
    if inf_bias:
        D = np.where(rng.random((S, P, I)) < 0.3, -np.inf, 0.0).astype(np.float32)
    G = rng.standard_normal((S, P, J)).astype(np.float32)
    return U, V, D, G


def _value_and_grads(f, arrays, device):
    U, V, D, G = (torch.tensor(a, device=device) for a in arrays)
    ts = [t.requires_grad_(True) for t in (U, V, D)]
    out = f(*ts)
    grads = torch.autograd.grad(out, ts, G)
    return out.detach(), grads


@pytest.mark.parametrize("shape,inf_bias", CASES)
def test_kernel_matches_plain_version(card, shape, inf_bias):
    arrays = _operands(shape, seed=7, inf_bias=inf_bias)
    launches = (tk.FWD_LAUNCHES, tk.BWD_LAUNCHES)
    got, ggot = _value_and_grads(tk.lowrank_logsumexp, arrays, card)
    torch.cuda.synchronize()
    assert (tk.FWD_LAUNCHES, tk.BWD_LAUNCHES) == (launches[0] + 1, launches[1] + 1)
    want, gwant = _value_and_grads(tk.reference_lowrank_logsumexp, arrays, card)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for a, b in zip(ggot, gwant):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_kernel_computes_only_the_gradients_asked_for(card):
    U, V, D, G = (torch.tensor(a, device=card)
                  for a in _operands((1, 3, 50, 7, 36), 1, False))
    Dg = D.clone().requires_grad_(True)
    (dD,) = torch.autograd.grad(tk.lowrank_logsumexp(U, V, Dg), [Dg], G)
    Dr = D.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(tk.reference_lowrank_logsumexp(U, V, Dr), [Dr], G)
    torch.testing.assert_close(dD, want, rtol=1e-4, atol=1e-5)


def test_wrapper_raises_on_what_the_kernel_does_not_take(card):
    U = torch.zeros(1, 2, 3, 4, device=card)
    V = torch.zeros(1, 5, 4, device=card)
    D = torch.zeros(1, 2, 3, device=card)
    with pytest.raises(ValueError, match="devices"):
        tk.lowrank_logsumexp(U.cpu(), V, D)
    with pytest.raises(ValueError, match="float32"):
        tk.lowrank_logsumexp(U.double(), V, D)
    with pytest.raises(ValueError, match="contiguous"):
        tk.lowrank_logsumexp(U.transpose(1, 2).contiguous().transpose(1, 2), V, D)


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict)
            else (DT(v.data.to(device), v.dims) if isinstance(v, DT) else v)
            for k, v in tree.items()}


def test_qem_step_on_card_matches_cpu(card, monkeypatch):
    monkeypatch.setenv("ALAN_TPU_LOWRANK_MIN", "1")
    monkeypatch.setenv("ALAN_TPU_LAZY_LOWRANK", "1")
    K = 30
    out = {}
    tree = None
    for device in ("cpu", card):
        ps, data, cov = tml.load_data_covariates(seed=3, M=20, N=5, device=device)
        prob = tml.grouped_problem(ps, data, cov, device=device)
        step, state = train.qem(prob, K, lr=0.3, device=device)
        if tree is None:
            tree, _ = prob.Q._sample(K, False, PermutationSampler,
                                     prob.all_platedims,
                                     torch.Generator().manual_seed(5))
        launches, calls = tk.FWD_LAUNCHES, tlr.CONTRACT_CALLS
        out[str(device)] = step(state, sample=_tree_to(tree, device))
        assert tlr.CONTRACT_CALLS == calls + 1
        if device == card:
            assert tk.FWD_LAUNCHES == launches + 1
    (_, q_cpu), e_cpu = out["cpu"]
    (_, q_card), e_card = out[str(card)]
    assert abs(float(e_card) - float(e_cpu)) <= 1e-5 * abs(float(e_cpu))
    for group in ("qem_params", "qem_means"):
        for k, v in q_cpu[group].items():
            w = q_card[group][k].with_dims_front(list(v.dims))
            torch.testing.assert_close(w.data.cpu(), v.data, rtol=1e-4, atol=1e-4)
