"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card and ``nvcc`` and skips without them.
The file imports neither JAX nor ``alan_tpu``, so on a machine with a card
and no JAX it runs without the suite's conftest:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

* ``lowrank_logsumexp`` forward and all three gradients against
  ``reference_lowrank_logsumexp`` on the same CUDA tensors: rtol/atol 1e-5
  forward, rtol 1e-4 / atol 1e-5 gradients (the tolerances of
  ``tests/test_lowrank_lazy.py``), on random operands, -inf biases, ragged
  edges of the tensor-core tiles, feature axes taken in chunks and (by the
  f64 rule) the Normal's factors with heavy cancellation; one forward and
  one backward launch per call, whichever gradients are asked for; a lazy
  factor with a wide feature axis reaches the kernels; the backward's
  launches by mode (dD, dD and dU, dV);
* one grouped-MovieLens QEM step on the card (lazy path forced, so z's
  factor runs through the kernels) against the same step on the CPU (the
  plain version), from the same particles; one VI step of grouped MovieLens
  with its opt Q through the kernels (dU and dV launched) against the dense
  route on the card, from the same draws;
* the small-K chain kernels (several tree levels a launch, forward and
  backward, over whole chains) against the level-by-level plain version
  (``reference_level``) on the same CUDA tensors, at covid's chain (2760
  chains, T = 109, K = 30), T at and around covid's segment of 8, K = 45
  (segments of 4), K = 2, K = 100, odd T and -inf entries: rtol/atol 1e-5
  forward, rtol 1e-4 / atol 1e-5 gradients, one launch each way per entry
  of the launch plan; one launch against ``reference_segment``; the
  kernels' shared memory against the planner's; their logarithm against
  ``logf``; and their refusal of K out of range;
* the joint-shift repair on peaked operators (log-densities of a Normal of
  scale 0.01 between particle sets of spread 1): the chain kernels with
  their fix-ups at covid's chain width (K = 30, T = 16) and the fused
  kernel with its fix-ups at K = 128 against the repaired plain versions
  on the card (rtol/atol 1e-5 values, rtol/atol 1e-4 gradients) and a
  float64 log-space evaluation; the same entries repaired on both sides;
* the fused route's joint-shift fix-ups (forward and backward) on peaked
  operators, K = 128, 257 and 1000, M and N off the tiles, nb = 1 to 6, and
  an all -inf row, column and operand: against the plain version and
  float64, the joint entries counted alike, unflagged entries bitwise the
  product's, the kept state and the backward against their plain versions,
  the backward bitwise the same in two calls;
* the fused log-matmul kernel against ``reference_logmmexp``: both levels
  of the AR(1) chain at K = 1000 ((2, 1000, 1000) and batch 1), a ragged
  shape, -inf rows and sums of products in [e^-80, e^-78], rtol/atol 1e-5;
  its pre-pass bitwise against ``reference_prepass``;
* ``train.scan_steps`` (a captured CUDA graph) against the eager loop on
  small grouped MovieLens, QEM and VI through the lowrank kernels, and
  ``vmap_runs``'s rows against it; an optimizer that cannot be captured is
  refused;
* the factored forms of the LogNormal, Exponential, Gamma, Chi2 and Beta
  (rank F = 2, 1, 2, 2, 2) contracted by the lowrank kernels against their
  materialised form on the card, value and the gradients of x, of the
  parameters and of an x-side term; the kernels at F = 1 and 2 among the
  cases above;
* ``scan_steps`` and ``vmap_runs`` of a planned step at world size 1
  (NCCL): small grouped MovieLens under plate + K sharding through the
  lowrank kernels and small covid under the T-sharded chain, bitwise the
  eager planned loop;
* covid with its corr_Q proposal (a MultivariateNormal, whose Cholesky
  factor the graph holds): ``scan_steps`` against the eager loop;
* each kernel under ``Split`` and under ``checkpoint`` inside a
  ``scan_steps`` capture (QEM steps of small grouped MovieLens through the
  lowrank kernels, small covid through the chain kernels at K = 10 and
  through the fused kernel at K = 128) against the eager loop with no
  strategy: ELBOs 1e-5 relative, state 1e-4, the captured loop bitwise its
  eager loop under the same strategy, the kernels launched in every chunk;
* HMC and NUTS (``mcmc.run_hmc``, ``nuts.run_nuts``) on the linear
  Gaussian: the captured loops bitwise the eager loops;
* a checkpoint resume on the card: 4 captured covid QEM steps bitwise 2, a
  save, a load into a fresh problem and 2 more.
"""
import numpy as np
import pytest
import torch

from alan_tpu_torch import train
from alan_tpu_torch.dims import DT
from alan_tpu_torch.models import movielens as tml
from alan_tpu_torch.ops import lowrank as tlr
from alan_tpu_torch.ops import logmmexp_kernel as tlk
from alan_tpu_torch.ops import lowrank_kernel as tk
from alan_tpu_torch.ops import smallk_kernel as tsk
from alan_tpu_torch.sampler import PermutationSampler
from lowrank_operands import normal_factor_operands

pytestmark = pytest.mark.cuda

CASES = [
    ((1, 20, 300, 40, 6), False),    # single i-chunk
    ((2, 9, 1300, 130, 4), False),   # overhang on every axis
    ((1, 3, 50, 7, 36), False),      # tiny j, the main path's F
    ((1, 1, 257, 1, 2), False),      # degenerate plate/parent
    ((1, 4, 64, 5, 3), True),        # -inf bias rows
    ((2, 5, 130, 40, 41), False),    # F just past 40: two dU / dV blocks
    ((1, 3, 70, 9, 80), False),      # F = 80: two dU / dV blocks
    ((1, 70000, 3, 5, 2), False),    # P above a launch's grid.y limit
    ((1, 5, 1037, 203, 36), False),  # the main path's F, I and J off the 64 / 128 tiles
    ((1, 6, 300, 90, 36), "cancellation"),   # Normal factors, terms 1e2-1e4 x the score
    ((1, 2, 40, 30, 104), False),    # one chunk forward and dD, two with dU / dV
    ((1, 3, 130, 70, 150), False),   # F in shared-memory chunks in every mode
    ((1, 300, 1000, 1000, 1), False),  # the Exponential's factor at K=1000
    ((1, 300, 1000, 1000, 2), False),  # the Gamma's, Chi2's, Beta's and LogNormal's
    ((1, 7, 203, 77, 1), False),     # F = 1 off the tiles
    ((1, 7, 203, 77, 2), True),      # F = 2 off the tiles, -inf rows
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return torch.device("cuda")


def _operands(shape, seed, inf_bias):
    if inf_bias == "cancellation":
        return normal_factor_operands(shape, seed, 1.0, 0.3, 3e-4)
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
    if inf_bias != "cancellation":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        for a, b in zip(ggot, gwant):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        return
    # heavy cancellation: the plain f32 version is no exact reference, so a
    # result off the bound passes if it is as close as the plain version to
    # an f64 evaluation (the rule of chip_smoke.py)
    exact, gexact = _value_and_grads(tk.reference_lowrank_logsumexp,
                                     [a.astype(np.float64) for a in arrays], card)
    for a, b, c, rtol in zip((got, *ggot), (want, *gwant), (exact, *gexact),
                             (1e-5, 1e-4, 1e-4, 1e-4)):
        err64 = (a.double() - c).abs().max()
        plain64 = (b.double() - c).abs().max()
        assert torch.allclose(a, b, rtol=rtol, atol=1e-5) or err64 <= plain64, \
            (err64.item(), plain64.item())


def test_kernel_computes_only_the_gradients_asked_for(card):
    U, V, D, G = (torch.tensor(a, device=card)
                  for a in _operands((1, 3, 50, 7, 36), 1, False))
    Dg = D.clone().requires_grad_(True)
    (dD,) = torch.autograd.grad(tk.lowrank_logsumexp(U, V, Dg), [Dg], G)
    Dr = D.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(tk.reference_lowrank_logsumexp(U, V, Dr), [Dr], G)
    torch.testing.assert_close(dD, want, rtol=1e-4, atol=1e-5)


def test_one_launch_each_way_per_call(card):
    U, V, D, G = (torch.tensor(a, device=card)
                  for a in _operands((1, 4, 300, 70, 36), 2, False))
    for wanted in ([D], [U, D], [V, D], [U, V, D]):
        ts = {id(t): t.clone().requires_grad_(any(t is w for w in wanted))
              for t in (U, V, D)}
        Ut, Vt, Dt = (ts[id(t)] for t in (U, V, D))
        before = (tk.FWD_LAUNCHES, tk.BWD_LAUNCHES)
        modes = (tk.DD_LAUNCHES, tk.DU_LAUNCHES, tk.DV_LAUNCHES)
        out = tk.lowrank_logsumexp(Ut, Vt, Dt)
        assert (tk.FWD_LAUNCHES, tk.BWD_LAUNCHES) == (before[0] + 1, before[1])
        torch.autograd.grad(out, [ts[id(w)] for w in wanted], G)
        torch.cuda.synchronize()
        assert (tk.FWD_LAUNCHES, tk.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
        # by mode: dD alone, or dD with dU; dV beside either where asked for
        want_U, want_V = Ut.requires_grad, Vt.requires_grad
        assert (tk.DD_LAUNCHES - modes[0], tk.DU_LAUNCHES - modes[1],
                tk.DV_LAUNCHES - modes[2]) == (int(not want_U), int(want_U), int(want_V))


def test_wide_lazy_factor_reaches_the_kernels(card):
    """A Normal factor of 75 dims (F = 150, chunked in shared memory) is
    contracted by the kernels, as its dense form is."""
    rng = np.random.default_rng(4)
    x = DT(torch.tensor(rng.standard_normal((40, 3, 75)), dtype=torch.float32,
                        device=card), ("K_z", "p"))
    params = {"loc": DT(torch.tensor(rng.standard_normal((9, 75)), dtype=torch.float32,
                                     device=card), ("K_g",)),
              "scale": DT(torch.tensor(rng.uniform(0.5, 2.0, (9, 75)), dtype=torch.float32,
                                       device=card), ("K_g",))}
    lazy = tlr.lowrank_logprob_lazy("Normal", x, params)
    launches = tk.FWD_LAUNCHES
    got = lazy.contract(("K_z",), [])
    assert got is not None and tk.FWD_LAUNCHES == launches + 1
    want = torch.logsumexp(lazy.materialize().with_dims_front(["K_z", "p", "K_g"]).data, 0)
    torch.testing.assert_close(got.with_dims_front(["p", "K_g"]).data, want,
                               rtol=1e-5, atol=1e-4)


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


def test_vi_step_on_card_matches_plain_route(card, monkeypatch):
    """One VI step of grouped MovieLens with its opt Q through the lazy
    route (the kernels, all three gradients: z's draw lies in U, mu_z's and
    psi_z's in V) against the same step through the dense route, from the
    same draws on the card."""
    monkeypatch.setenv("ALAN_TPU_LOWRANK_MIN", "1")
    monkeypatch.setenv("ALAN_TPU_LAZY_LOWRANK", "1")
    K = 30
    ps, data, cov = tml.load_data_covariates(seed=3, M=20, N=5, device=card)
    prob = tml.grouped_problem(ps, data, cov, "opt", device=card)
    step, state = train.vi(prob, K, lr=0.01, device=card)
    out = {}
    for route in ("lazy", "dense"):
        if route == "dense":
            monkeypatch.setenv("ALAN_TPU_NO_LAZY_LOWRANK", "1")
        modes = (tk.DU_LAUNCHES, tk.DV_LAUNCHES)
        out[route] = step(state, torch.Generator(device=card).manual_seed(5))
        torch.cuda.synchronize()
        launched = (tk.DU_LAUNCHES - modes[0], tk.DV_LAUNCHES - modes[1])
        assert launched == ((1, 1) if route == "lazy" else (0, 0))
    (_, q_lazy, _), e_lazy = out["lazy"]
    (_, q_dense, _), e_dense = out["dense"]
    assert abs(float(e_lazy) - float(e_dense)) <= 1e-4 * abs(float(e_dense))
    for k, v in q_dense["opt"].items():
        w = q_lazy["opt"][k].with_dims_front(list(v.dims))
        torch.testing.assert_close(w.data, v.data, rtol=1e-4, atol=1e-4)


# ---- the small-K chain kernels ------------------------------------------------

SMALLK_CASES = [
    ((2760, 109, 30), False),   # covid's full chain
    ((130, 8, 2), False),       # K = 2
    ((16, 5, 100), False),      # K = 100, odd T
    ((40, 7, 30), True),        # -inf entries
    ((3, 4, 128), False),       # the largest K the kernels take
    ((40, 3, 30), False),       # T below covid's segment of 8
    ((40, 8, 30), False),       # T at it
    ((40, 9, 30), False),       # one past it
    ((40, 17, 30), False),      # two segments and one
    ((24, 9, 45), False),       # segments of 4
]


def _chain_operands(shape, inf, seed, device):
    B, T, K = shape
    rng = np.random.default_rng(seed)
    ms = (rng.standard_normal((B, T, K, K)) * 2 - 1).astype(np.float32)
    if inf:
        ms[:, 2, :, 3] = -np.inf
        ms[:, 3, 1, :] = -np.inf
    W = rng.standard_normal((B, K, K)).astype(np.float32)
    return torch.tensor(ms, device=device), torch.tensor(W, device=device)


def _plain_chain(x):
    while x.shape[1] != 1:
        x = tsk.reference_level(x)
    return x[:, 0]


def _chain_value_and_grad(chain, ms, W):
    """The chain's value and d(sum(chain * W))/d ms."""
    x = ms.clone().requires_grad_(True)
    y = chain(x)
    (g,) = torch.autograd.grad((y * W).sum(), [x])
    return y.detach(), g


@pytest.mark.parametrize("shape,inf", SMALLK_CASES)
def test_smallk_chain_matches_plain_version(card, shape, inf):
    ms, W = _chain_operands(shape, inf, 11, card)
    launches = (tsk.FWD_LAUNCHES, tsk.BWD_LAUNCHES)
    got, ggot = _chain_value_and_grad(tsk.chain_logmmexp_smallk, ms, W)
    torch.cuda.synchronize()
    counts = (tsk.FWD_LAUNCHES - launches[0], tsk.BWD_LAUNCHES - launches[1])
    assert counts[0] == counts[1] == len(tsk.launch_plan(shape[1], shape[2]))
    want, gwant = _chain_value_and_grad(_plain_chain, ms, W)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ggot, gwant, rtol=1e-4, atol=1e-5)


def _peaked(rng, lead, K, steps, device):
    """Log-transition operators (lead..., steps, K, K): log N(x[t + 1, j];
    x[t, i], 0.01) between particle sets of spread 1 on a random walk."""
    x = rng.normal(0, 1, (*lead, steps + 1, K))
    x = x + np.cumsum(rng.normal(0, 0.3, (*lead, steps + 1, 1)), axis=-2)
    d = (x[..., 1:, None, :] - x[..., :-1, :, None]) / 0.01
    ms = (-0.5 * d * d - np.log(0.01 * np.sqrt(2 * np.pi))).astype(np.float32)
    return torch.tensor(ms, device=device)


def _f64_logmmexp(A, B):
    return torch.logsumexp(A.double()[..., :, :, None] + B.double()[..., None, :, :], -2)


def _joints(fn):
    """fn()'s result and the entries that took the joint shift on the way."""
    count = torch.zeros((), dtype=torch.int64, device="cuda")
    old, tlk.JOINT_COUNT = tlk.JOINT_COUNT, count
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        tlk.JOINT_COUNT = old
    return out, int(count)


def test_peaked_chain_kernels_match_plain_and_f64(card):
    ms = _peaked(np.random.default_rng(40), (8 * 30,), 30, 16, card)
    lse = lambda y: torch.logsumexp(y.flatten(-2), -1).sum()

    def run(chain):
        x = ms.clone().requires_grad_(True)
        y = chain(x)
        (g,) = torch.autograd.grad(lse(y), [x])
        return y.detach(), g
    (got, ggot), n_kernel = _joints(lambda: run(tsk.chain_logmmexp_smallk))
    (want, gwant), n_plain = _joints(lambda: run(_plain_chain))
    x = ms.double()
    while x.shape[1] != 1:
        n = x.shape[1]
        prod = _f64_logmmexp(x[:, 0:n - n % 2:2], x[:, 1:n:2])
        x = torch.cat([prod, x[:, n - 1:]], 1) if n % 2 else prod
    assert n_kernel == n_plain > 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ggot, gwant, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.double(), x[:, 0], rtol=1e-5, atol=1e-5)


def test_peaked_fused_kernel_matches_plain_and_f64(card):
    AB = _peaked(np.random.default_rng(41), (6,), 128, 2, card)
    A, B = AB[:, 0].contiguous(), AB[:, 1].contiguous()
    W = torch.randn(6, 128, 128, device=card)

    def run(f):
        a, b = A.clone().requires_grad_(True), B.clone().requires_grad_(True)
        y = f(a, b)
        return (y.detach(), *torch.autograd.grad((y * W).sum(), [a, b]))
    launches = (tlk.LAUNCHES, tlk.BWD_LAUNCHES)
    got, n_kernel = _joints(lambda: run(tlk.logmmexp_fused))
    assert (tlk.LAUNCHES - launches[0], tlk.BWD_LAUNCHES - launches[1]) == (1, 1)
    want, n_plain = _joints(lambda: run(tlk.reference_logmmexp))
    a64, b64 = A.double().requires_grad_(True), B.double().requires_grad_(True)
    y64 = _f64_logmmexp(a64, b64)
    exact = (y64.detach(), *torch.autograd.grad((y64 * W.double()).sum(), [a64, b64]))
    assert n_kernel > 0 and abs(n_kernel - n_plain) <= n_plain // 1000
    for g, w, e, tol in zip(got, want, exact, (1e-5, 1e-4, 1e-4)):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)
        torch.testing.assert_close(g.double(), e, rtol=tol, atol=tol)


def test_smallk_fixup_shared_memory_matches_the_planner(card):
    """The fix-ups' layouts: bytes of shared memory, the floats of device
    memory the backward's records take where they do not fit, and the
    floats the forward keeps for the backward."""
    import ctypes
    from alan_tpu_torch.ops.native import load
    lib = load("smallk_logmmexp", tsk._SIGNATURES)
    records = ctypes.c_int(-1)
    for K in (1, 2, 7, 30, 45, 64, 97, 98, 99, 100, 128):
        for m in (1, 2, 3, 4, 5):
            assert lib.smallk_fixup_saved_floats(K, m) == tsk.fixup_saved(K, m)
            for bwd in (False, True):
                nbytes = lib.smallk_fixup_smem_bytes(K, m, int(bwd), ctypes.byref(records))
                _, rec, want = tsk.fixup_layout(K, m, bwd)
                assert nbytes == want == tsk.fixup_smem(K, m, bwd)
                assert records.value == (tsk.fixup_records(K, m) if bwd and want and not rec
                                         else 0)


def _inner_only(rng, B, K, device):
    """Segments of 8 operators whose level-1 products keep c >= 1 and whose
    level-2 product (0 1)(2 3) loses every term to the separate shifts:
    (0 1) has rows v (spread 1000), (2 3) columns u, peaking apart."""
    x = (rng.standard_normal((B, 8, K, K)) * 2 - 1)
    v, u = rng.uniform(-1000, 0, (B, K)), rng.uniform(-1000, 0, (B, K))
    x[:, 0] = -1000
    x[:, 0, :, 0] = 0
    x[:, 1] = v[:, None, :] - 5
    x[:, 1, 0, :] = v
    x[:, 2] = u[:, :, None] - 5
    x[:, 2, :, 0] = u
    x[:, 3] = -1000
    x[:, 3, 0, :] = 0
    return torch.tensor(x.astype(np.float32), device=device)


def _fixup_operands(kind, rng, card):
    """(operators, m) of one launch for the fix-up cases."""
    if kind == "mixed":       # flagged and unflagged segments in one launch
        x = torch.cat([_chain_operands((3, 17, 30), False, 13, card)[0],
                       _peaked(rng, (3,), 30, 17, card)])
        x[0, 8:16] = _peaked(rng, (1,), 30, 8, card)[0]
        return x, 3
    if kind == "inner_only":
        return _inner_only(rng, 4, 30, card), 3
    if kind == "no_finite_term":
        x = _peaked(rng, (3,), 30, 9, card)
        x[0, 2, 4, :] = -np.inf   # a row of A: entries (4, k) have no finite term
        x[1, 5, :, 7] = -np.inf   # a column of B
        x[2, 6] = -np.inf         # a whole operator: no entry of its product has one
        return x, 3
    K, T = kind
    return _peaked(rng, (5,), K, T, card), tsk.launch_plan(T, K)[0]


@pytest.mark.parametrize("kind", ["mixed", "inner_only", "no_finite_term",
                                  (7, 17), (30, 9), (45, 9), (64, 3),
                                  (30, 3), (30, 8), (30, 17)])
def test_smallk_fixups_match_plain_version(card, kind):
    """One launch (fast kernels and fix-ups) against the plain version:
    values rtol/atol 1e-5, gradients 1e-4, the joint entries counted alike.
    Unflagged segments are bitwise the fast kernels' (a launch without
    flags), and the backward given the forward's flags is bitwise the one
    that finds them itself.  The kernels' gradients are finite, 0 for an
    operand entry that is -inf, and equal to the plain version's at every
    entry (an entry with no finite term passes no gradient in both)."""
    from alan_tpu_torch.ops.native import load, ptr, stream
    x, m = _fixup_operands(kind, np.random.default_rng(50), card)
    x = x.contiguous()
    xg = x.clone().requires_grad_(True)
    _, flags = tsk.fast_fwd(x, m)
    assert int(flags.sum()) > 0
    launches = (tsk.FWD_LAUNCHES, tsk.BWD_LAUNCHES)
    got, n_kernel = _joints(lambda: tsk.logmmexp_segment(xg, m))
    assert (tsk.FWD_LAUNCHES - launches[0], tsk.BWD_LAUNCHES - launches[1]) == (1, 0)
    g = torch.randn(got.shape, device=card, generator=torch.Generator(card).manual_seed(3))
    (dx,) = torch.autograd.grad(got, [xg], g)
    xr = x.clone().requires_grad_(True)
    want, n_plain = _joints(lambda: tsk.reference_segment(xr, m))
    (dwant,) = torch.autograd.grad(want, [xr], g)
    assert n_kernel == n_plain > 0
    torch.testing.assert_close(got.detach(), want.detach(), rtol=1e-5, atol=1e-5)
    assert torch.isfinite(dx).all()
    assert (dx[~torch.isfinite(x)] == 0).all()
    torch.testing.assert_close(dx, dwant, rtol=1e-4, atol=1e-4)
    # the backward that finds its flags itself: bitwise the one given the
    # forward's (which skips their segments)
    out2, flags2 = tsk.fast_fwd(x, m)
    saved = tsk.fixup_fwd(x, out2, flags2, m, save=True)
    own, own_flags = tsk.fast_bwd(x, g, m)
    tsk.fixup_bwd(x, g, own, own_flags, saved, m)
    assert torch.equal(own_flags, flags) and torch.equal(out2, got.detach())
    assert torch.equal(own, dx)
    # unflagged segments: bitwise the fast kernels' alone (no flags, no stop)
    lib = load("smallk_logmmexp", tsk._SIGNATURES)
    nB, n, K, _ = x.shape
    fast, fast_dx = torch.empty_like(got), torch.empty_like(x)
    assert lib.smallk_segment_fwd(ptr(x), ptr(fast), None, nB, n, K, m,
                                  tsk.layout_for(K, m, False), stream(x)) == 0
    assert lib.smallk_segment_bwd(ptr(x), ptr(g), ptr(fast_dx), None, nB, n, K, m,
                                  tsk.layout_for(K, m, True), stream(x)) == 0
    torch.cuda.synchronize()
    seg = flags.reshape(nB, -1).bool()
    assert torch.equal(got.detach()[~seg], fast[~seg])
    per_op = seg.repeat_interleave(1 << m, 1)[:, :n]
    assert torch.equal(dx[~per_op], fast_dx[~per_op])


@pytest.mark.parametrize("n,K,m", [(109, 30, 3), (14, 30, 3), (2, 30, 1), (11, 5, 2)])
def test_smallk_launch_matches_reference_segment(card, n, K, m):
    ms, _ = _chain_operands((7, n, K), False, 12, card)
    x = ms.clone().requires_grad_(True)
    out = tsk.logmmexp_segment(x, m)
    g = torch.randn_like(out)
    (dx,) = torch.autograd.grad(out, [x], g)
    xr = ms.clone().requires_grad_(True)
    want = tsk.reference_segment(xr, m)
    (dxr,) = torch.autograd.grad(want, [xr], g)
    torch.testing.assert_close(out.detach(), want.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dx, dxr, rtol=1e-4, atol=1e-5)


def test_smallk_shared_memory_matches_the_planner(card):
    from alan_tpu_torch.ops.native import load
    lib = load("smallk_logmmexp", tsk._SIGNATURES)
    for K in (1, 2, 30, 45, 100, 128):
        for m in (1, 2, 3, 4, 5):
            for bwd in (False, True):
                for direct in (0, 1):
                    assert (lib.smallk_smem_bytes(K, m, int(bwd), direct)
                            == tsk.segment_smem(K, m, bwd, direct))


def test_smallk_logarithm_is_logf(card):
    """The epilogue's branch-free logarithm equals logf on every float that
    c + tiny can be (K <= 128)."""
    assert tsk.log_mismatches() == 0


def test_smallk_kernels_refuse_k_out_of_range(card):
    for K in (0, tsk.MAX_K + 1):
        x = torch.zeros((2, 4, K, K), device=card)
        with pytest.raises(ValueError, match="K="):
            tsk.logmmexp_segment(x, 1)
    with pytest.raises(ValueError, match="float32"):
        tsk.logmmexp_segment(torch.zeros((2, 4, 5, 5), device=card, dtype=torch.float64), 1)


# ---- the fused log-matmul kernel ----------------------------------------------

def _small_sums(shape, rng):
    """Row maxima of A at k = 0, column maxima of B at k = 1, both near 37,
    every product of two exponentials in [e^-80, e^-78]: above FLT_MIN,
    with + FLT_MIN counting in the log, and out near 0."""
    nb, M, K, N = shape
    c, d = rng.uniform(36, 38, (nb, M, 1)), rng.uniform(36, 38, (nb, 1, N))
    A, B = c - rng.uniform(39, 40, (nb, M, K)), d - rng.uniform(39, 40, (nb, K, N))
    A[:, :, 0], B[:, 1, :] = c[:, :, 0], d[:, 0, :]
    A[:, :, 1] = c[:, :, 0] - rng.uniform(78, 80, (nb, M))
    B[:, 0, :] = d[:, 0, :] - rng.uniform(78, 80, (nb, N))
    return A.astype(np.float32), B.astype(np.float32)


@pytest.mark.parametrize("shape,kind", [((2, 1000, 1000, 1000), "randn"),
                                        ((1, 1000, 1000, 1000), "randn"),
                                        ((3, 130, 257, 77), "randn"),
                                        ((2, 70, 300, 65), "inf"),
                                        ((2, 300, 128, 300), "small_sums")])
def test_fused_logmmexp_matches_plain_version(card, shape, kind):
    nb, M, K, N = shape
    rng = np.random.default_rng(13)
    A = (rng.standard_normal((nb, M, K)) * 3).astype(np.float32)
    B = (rng.standard_normal((nb, K, N)) * 3).astype(np.float32)
    if kind == "inf":
        A[:, ::7] = -np.inf
        B[:, :, 5] = -np.inf
    if kind == "small_sums":
        A, B = _small_sums(shape, rng)
    A, B = torch.tensor(A, device=card), torch.tensor(B, device=card)
    launches = tlk.LAUNCHES
    got = tlk.logmmexp_fused(A, B)
    torch.cuda.synchronize()
    assert tlk.LAUNCHES == launches + 1
    want = tlk.reference_logmmexp(A, B)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 1000, 1000, 1000), (3, 130, 257, 77)])
def test_fused_prepass_is_its_plain_version(card, shape):
    nb, M, K, N = shape
    rng = np.random.default_rng(14)
    A = torch.tensor((rng.standard_normal((nb, M, K)) * 3).astype(np.float32), device=card)
    B = torch.tensor((rng.standard_normal((nb, K, N)) * 3).astype(np.float32), device=card)
    A[:, 1] = -np.inf
    B[:, :, 2] = -np.inf
    for bn in tlk.TILE_WIDTHS:
        got = tlk._prepass(A, B, bn)
        want = tlk.reference_prepass(A, B, bn)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


# ---- the fused log-matmul's joint-shift fix-ups ------------------------------------

def _fused_fixup_operands(nb, M, K, N, kind, card):
    """Peaked operators (``_peaked``'s first two of each of nb chains, cut
    to M rows of A and N columns of B): flagged and unflagged entries mixed;
    ``"inf"`` adds an all -inf row of A (batch 0), column of B (batch 1)
    and whole A (batch 2)."""
    AB = _peaked(np.random.default_rng(nb * K + M), (nb,), K, 2, card)
    A, B = AB[:, 0, :M].contiguous(), AB[:, 1, :, :N].contiguous()
    if kind == "inf":
        A[0, 3] = -np.inf
        B[1, :, 5] = -np.inf
        A[2] = -np.inf
    return A, B


@pytest.mark.parametrize("nb,M,K,N,kind", [(1, 128, 128, 128, "peaked"),
                                           (6, 100, 128, 77, "peaked"),
                                           (2, 130, 257, 65, "peaked"),
                                           (3, 200, 1000, 150, "peaked"),
                                           (3, 96, 257, 70, "inf")])
def test_fused_fixups_match_plain_version(card, nb, M, K, N, kind):
    """The fused route's forward and backward fix-ups against the plain
    version (values rtol/atol 1e-5, the gradients of a random linear
    function 1e-4) and, without -inf, float64; the entries that took the
    joint shift within 0.1% of the plain version's; unflagged entries
    bitwise the product's; what the forward keeps against its plain
    version (masks and t* bitwise, the reference terms bitwise, -log2 of
    the sum to 1e-5); the backward fix-up against its plain version from
    the kept records, and bitwise the same in two calls."""
    A, B = _fused_fixup_operands(nb, M, K, N, kind, card)
    W = torch.randn((nb, M, N), device=card, generator=torch.Generator(card).manual_seed(5))

    def run(f, A, B):
        a, b = A.clone().requires_grad_(True), B.clone().requires_grad_(True)
        y = f(a, b)
        return (y.detach(), *torch.autograd.grad((y * W.to(y.dtype)).sum(), [a, b]))
    launches = (tlk.LAUNCHES, tlk.BWD_LAUNCHES)
    got, n_kernel = _joints(lambda: run(tlk.logmmexp_fused, A, B))
    assert (tlk.LAUNCHES - launches[0], tlk.BWD_LAUNCHES - launches[1]) == (1, 1)
    want, n_plain = _joints(lambda: run(tlk.reference_logmmexp, A, B))
    assert n_kernel > 0 and abs(n_kernel - n_plain) <= n_plain // 1000
    for g, w, tol in zip(got, want, (1e-5, 1e-4, 1e-4)):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)
    if kind != "inf":
        exact = run(_f64_logmmexp, A, B)
        for g, e, tol in zip(got, exact, (1e-5, 1e-4, 1e-4)):
            torch.testing.assert_close(g.double(), e.double(), rtol=tol, atol=tol)
    else:
        assert (got[1][0, 3] == 0).all() and (got[2][1, :, 5] == 0).all()
        assert (got[1][2] == 0).all()
    out, flags, kept = tlk._launch(A, B, save=True)
    bn = tlk.tile_n(nb, M, N, tlk._sms(A.device))
    product = tlk._product(*tlk._prepass(A, B, bn), nb, M, K, N, bn)
    assert torch.equal(out[~flags], product[~flags]) and torch.equal(out, got[0])
    rec, recT, rows, cols = kept
    want_rows, want_cols = tlk.fixup_masks(flags)
    assert torch.equal(rows, want_rows.flatten()) and torch.equal(cols, want_cols.flatten())
    assert torch.equal(recT.transpose(1, 2)[flags], rec[flags])
    want_rec = tlk.reference_fixup_state(A, B, flags)
    for c in (0, 1, 3):
        assert torch.equal(rec[..., c][flags], want_rec[..., c][flags])
    torch.testing.assert_close(rec[..., 2][flags], want_rec[..., 2][flags], rtol=1e-5, atol=1e-5)
    g = W.contiguous()
    dA, dB = torch.zeros_like(A), torch.zeros_like(B)
    tlk._fixup_bwd(A, B, g, kept, dA, dB)
    want_dA, want_dB = tlk.reference_fixup_bwd(A, B, g, rec, flags)
    torch.testing.assert_close(dA, want_dA, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dB, want_dB, rtol=1e-4, atol=1e-5)
    first = tlk._launch_bwd(A, B, flags, kept, g)
    second = tlk._launch_bwd(A, B, flags, kept, g)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_fused_fixup_kept_sizes_match_the_host(card):
    """The kept masks' words, as the C interface counts them, against the
    wrapper's; the forward without a gradient keeps nothing, and the
    backward refuses to run without what the forward kept."""
    lib = tlk._lib()
    for nb, M, N in ((1, 1, 1), (2, 1000, 1000), (3, 130, 77), (6, 64, 32), (1, 65, 33)):
        for cols in (0, 1):
            assert lib.logmmexp_fixup_mask_words(nb, M, N, cols) == \
                tlk.fixup_mask_words(nb, M, N, bool(cols))
    A, B = _fused_fixup_operands(1, 128, 128, 128, "peaked", card)
    out, flags, kept = tlk._launch(A, B)
    assert kept is None
    with pytest.raises(ValueError, match="kept"):
        tlk._launch_bwd(A, B, flags, None, torch.ones_like(out))


# ---- the captured loop ----------------------------------------------------------

@pytest.mark.parametrize("method", ["qem", "vi"])
def test_scan_steps_graph_matches_eager_loop(card, monkeypatch, method):
    """``scan_steps`` on the card (a captured CUDA graph, replayed) against
    the eager loop from a generator of the same seed, on small grouped
    MovieLens through the lowrank kernels: every ELBO within 1e-5
    relative, the final state within rtol/atol 1e-4, the generators
    advanced alike; a second call replays without capturing; each row of
    ``vmap_runs`` equals ``scan_steps`` from its run's generator."""
    monkeypatch.setenv("ALAN_TPU_LOWRANK_MIN", "1")
    monkeypatch.setenv("ALAN_TPU_LAZY_LOWRANK", "1")
    K, n = 30, 4
    ps, data, cov = tml.load_data_covariates(seed=3, M=20, N=5, device=card)
    qtype = "qem" if method == "qem" else "opt"
    prob = tml.grouped_problem(ps, data, cov, qtype, device=card)
    step, state0 = getattr(train, method)(prob, K, device=card)
    g_e, g_s = (torch.Generator(device=card).manual_seed(7) for _ in range(2))
    st_e, el_e = state0, []
    for _ in range(n):
        st_e, e = step(st_e, g_e)
        el_e.append(e)
    el_e = torch.stack(el_e)
    run = train.scan_steps(step, n)
    launches = tk.FWD_LAUNCHES
    st_s, el_s = run(state0, g_s)
    assert tk.FWD_LAUNCHES > launches and run.capture_seconds > 0
    torch.testing.assert_close(el_s, el_e, rtol=1e-5, atol=0)
    assert torch.equal(g_e.get_state(), g_s.get_state())
    for x, y in zip(train._flatten(st_s)[0], train._flatten(st_e)[0]):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)
    launches = tk.FWD_LAUNCHES
    _, el_again = run(state0, torch.Generator(device=card).manual_seed(7))
    assert tk.FWD_LAUNCHES == launches and run.capture_seconds == 0.0
    torch.testing.assert_close(el_again, el_s, rtol=0, atol=0)
    # three steps a graph: one replay of it, and a graph of one for the rest
    _, el_unrolled = train.scan_steps(step, n, unroll=3)(
        state0, torch.Generator(device=card).manual_seed(7))
    torch.testing.assert_close(el_unrolled, el_e, rtol=1e-5, atol=0)
    _, rows = train.vmap_runs(step, n, 2)(state0, 3)
    for r in range(2):
        _, e = run(state0, train.run_generator(3, r, card))
        torch.testing.assert_close(rows[r], e, rtol=1e-5, atol=0)
    assert not torch.allclose(rows[0], rows[1])


@pytest.mark.parametrize("optimizer,match", [
    # its step count on the host
    (lambda p: torch.optim.Adam(p, lr=0.01), "capturable=False"),
    # its momentum built at its first step: step 0 changes the state's structure
    (lambda p: torch.optim.SGD(p, lr=0.01, momentum=0.9), "structure"),
])
def test_scan_steps_refuses_an_uncapturable_optimizer(card, optimizer, match):
    """An optimizer whose state a graph cannot carry from replay to replay:
    ``scan_steps`` raises on the card, and runs no eager loop."""
    ps, data, cov = tml.load_data_covariates(seed=3, M=20, N=5, device=card)
    prob = tml.grouped_problem(ps, data, cov, "opt", device=card)
    step, state0 = train.vi(prob, 10, device=card, optimizer=optimizer)
    with pytest.raises(ValueError, match=match):
        train.scan_steps(step, 2)(state0, torch.Generator(device=card).manual_seed(0))


# ---- the factored families and covid corr_Q ------------------------------------------

def _family_factor(family, card, K=200, P=30, seed=5):
    """x over (K_z, p), the parameters over K_g, an x-side term; all carry
    a gradient."""
    rng = np.random.default_rng(seed)
    pos = lambda *s, lo=0.3: np.abs(rng.standard_normal(s)) + lo
    if family == "LogNormal":
        x, params = np.exp(rng.standard_normal((K, P)) * 0.5), {
            "loc": rng.standard_normal(K) * 0.3, "scale": pos(K, lo=0.4)}
    elif family == "Exponential":
        x, params = pos(K, P), {"rate": pos(K, lo=0.5)}
    elif family == "Gamma":
        x, params = pos(K, P), {"concentration": pos(K, lo=1.0), "rate": pos(K, lo=0.5)}
    elif family == "Chi2":
        x, params = pos(K, P), {"df": pos(K, lo=1.0)}
    else:
        u = pos(K, P)
        x, params = u / (u + 1.2), {"concentration1": pos(K, lo=0.8),
                                    "concentration0": pos(K, lo=0.8)}
    mk = lambda a, dims: DT(torch.tensor(a, dtype=torch.float32, device=card,
                                         requires_grad=True), dims)
    return (mk(x, ("K_z", "p")), {k: mk(v, ("K_g",)) for k, v in params.items()},
            mk(rng.standard_normal((K, P)), ("K_z", "p")))


@pytest.mark.parametrize("family", ["LogNormal", "Exponential", "Gamma", "Chi2", "Beta"])
def test_factored_family_contract_matches_materialised(card, monkeypatch, family):
    from alan_tpu_torch.dims import logsumexp_dims
    from alan_tpu_torch.distributions import families as tfam
    from alan_tpu_torch.distributions.dimdist import DimDist
    x, params, side = _family_factor(family, card)
    leaves = [x.data, *(v.data for v in params.values()), side.data]
    monkeypatch.setenv("ALAN_TPU_LOWRANK_MIN", "1")
    monkeypatch.setenv("ALAN_TPU_LAZY_LOWRANK", "1")
    lazy = DimDist(tfam.FAMILIES[family], **params).log_prob(x)
    assert getattr(lazy, "__lazy_dt__", False)
    assert lazy.U.pos_shape == ({"Exponential": 1}.get(family, 2),)
    launches = (tk.FWD_LAUNCHES, tk.BWD_LAUNCHES)
    got = lazy.contract(("K_z",), [side]).with_dims_front(["p", "K_g"]).data
    # the materialised form below reuses the factor's operands
    ggot = torch.autograd.grad(got.sum(), leaves, retain_graph=True)
    torch.cuda.synchronize()
    assert (tk.FWD_LAUNCHES, tk.BWD_LAUNCHES) == (launches[0] + 1, launches[1] + 1)
    want = logsumexp_dims(lazy.materialize() + side, ("K_z",)).with_dims_front(["p", "K_g"]).data
    gwant = torch.autograd.grad(want.sum(), leaves)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    for a, b in zip(ggot, gwant):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_covid_corrq_scan_matches_eager(card):
    """Small covid with its corr_Q proposal: ``scan_steps`` (the
    MultivariateNormal's Cholesky factor inside the captured graph) against
    the eager loop, ELBOs 1e-5 relative, state 1e-4; the chain kernels
    launch inside the graph."""
    from alan_tpu_torch.models import covid
    ps, _, data, _, cov, _ = covid.load_data_covariates(seed=0, nRs=8, nDs=30, device=card)
    prob = covid.generate_problem(ps, data, cov, "qem", corr_Q=True, device=card)
    step, state0 = train.qem(prob, 10, lr=0.1, device=card)
    n = 3
    st_e, el_e = train._eager(step, n, state0, torch.Generator(device=card).manual_seed(2))
    launches = tsk.FWD_LAUNCHES
    st_s, el_s = train.scan_steps(step, n)(state0, torch.Generator(device=card).manual_seed(2))
    torch.cuda.synchronize()
    assert tsk.FWD_LAUNCHES > launches
    torch.testing.assert_close(el_s, el_e, rtol=1e-5, atol=0)
    for x, y in zip(train._flatten(st_s)[0], train._flatten(st_e)[0]):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)
    cov_q = st_s[1]["qem_params"]["CM_alpha_covariance_matrix"].data
    assert int(torch.linalg.cholesky_ex(cov_q)[1]) == 0


# ---- computation strategies, the gold samplers and resume ------------------------

def _strategy_case(kind, card):
    """(problem, K, the strategy's Split, the launch counter of its kernel)."""
    from alan_tpu_torch import Split
    from alan_tpu_torch.models import covid
    if kind == "lowrank":
        ps, data, cov = tml.load_data_covariates(seed=3, M=20, N=5, device=card)
        return (tml.grouped_problem(ps, data, cov, "qem", device=card), 30,
                Split("plate_1", 7), (tk, "FWD_LAUNCHES"))
    ps, _, data, _, cov, _ = covid.load_data_covariates(seed=0, nRs=4, nDs=8, device=card)
    prob = covid.generate_problem(ps, data, cov, "qem", device=card)
    if kind == "chain":
        return prob, 10, Split("nRs", 3), (tsk, "FWD_LAUNCHES")
    return prob, 128, Split("nRs", 1), (tlk, "LAUNCHES")


@pytest.mark.parametrize("kind", ["lowrank", "chain", "fused"])
@pytest.mark.parametrize("strategy", ["split", "checkpoint"])
def test_strategy_inside_a_capture_matches_no_strategy(card, monkeypatch, kind, strategy):
    from alan_tpu_torch import checkpoint, no_checkpoint
    monkeypatch.setenv("ALAN_TPU_LOWRANK_MIN", "1")
    monkeypatch.setenv("ALAN_TPU_LAZY_LOWRANK", "1")
    prob, K, split, (mod, counter) = _strategy_case(kind, card)
    cs = split if strategy == "split" else checkpoint
    n = 3
    gen = lambda: torch.Generator(device=card).manual_seed(4)
    base_step, state0 = train.qem(prob, K, lr=0.1, computation_strategy=no_checkpoint,
                                  device=card)
    step, _ = train.qem(prob, K, lr=0.1, computation_strategy=cs, device=card)
    st_b, el_b = train._eager(base_step, n, state0, gen())
    before = getattr(mod, counter)
    st_e, el_e = train._eager(step, 1, state0, gen())
    per_step = getattr(mod, counter) - before
    chunks = 1 if strategy == "checkpoint" else len(split._split_bounds(
        prob.all_platedims[split.platename]))
    assert per_step >= chunks
    st_e, el_e = train._eager(step, n, state0, gen())
    st_s, el_s = train.scan_steps(step, n)(state0, gen())
    torch.cuda.synchronize()
    torch.testing.assert_close(el_e, el_b, rtol=1e-5, atol=1e-6)
    for x, y in zip(train._flatten(st_e)[0], train._flatten(st_b)[0]):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)
    assert torch.equal(el_s, el_e)
    for x, y in zip(train._flatten(st_s)[0], train._flatten(st_e)[0]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_gold_sampler_capture_is_bitwise_eager(card, monkeypatch, sampler):
    from alan_tpu_torch import BoundPlate, Normal, Plate, mcmc, named
    from alan_tpu_torch.nuts import run_nuts
    data_np = 1.5 + np.random.default_rng(0).standard_normal(10)
    P = BoundPlate(Plate(a=Normal(2.0, 2.0), T=Plate(d=Normal(lambda a: 2.5 * a, 3.0))),
                   {"T": 10}, device=card)
    data = {"d": named(torch.tensor(data_np, dtype=torch.float32, device=card), "T")}
    run = {"hmc": mcmc.run_hmc, "nuts": run_nuts}[sampler]
    kw = dict(num_samples=20, num_warmup=20, num_chains=4)
    if sampler == "nuts":
        kw["max_depth"] = 4
    gen = lambda: torch.Generator(device=card).manual_seed(11)
    captured, cd = run(P, data, generator=gen(), **kw)
    loop = mcmc._loop
    monkeypatch.setattr(mcmc, "_loop", lambda step, n, state, g: (
        (*train._eager(step, n, state, g), 0.0) if n else loop(step, n, state, g)))
    eager, ed = run(P, data, generator=gen(), **kw)
    assert torch.equal(cd["theta"], ed["theta"])
    assert cd["step_size"] == ed["step_size"] and cd["mean_accept"] == ed["mean_accept"]
    assert torch.isfinite(cd["theta"]).all()


def test_checkpoint_resume_on_the_card(card, tmp_path):
    from alan_tpu_torch.checkpointing import load_checkpoint, save_checkpoint
    from alan_tpu_torch.models import covid
    ps, _, data, _, cov, _ = covid.load_data_covariates(seed=0, nRs=4, nDs=8, device=card)
    make = lambda: train.qem(covid.generate_problem(ps, data, cov, "qem", device=card), 10,
                             lr="0.1/t@2", device=card)
    step, state0 = make()
    full, _ = train.scan_steps(step, 4)(state0, torch.Generator(device=card).manual_seed(3))
    gen = torch.Generator(device=card).manual_seed(3)
    half, _ = train.scan_steps(step, 2)(state0, gen)
    save_checkpoint(str(tmp_path / "ck"), {"state": half, "generator": gen})
    ck = load_checkpoint(str(tmp_path / "ck"))
    assert ck["generator"].device.type == "cuda"
    step2, _ = make()
    resumed, _ = train.scan_steps(step2, 2)(ck["state"], ck["generator"])
    for x, y in zip(train._flatten(full)[0], train._flatten(resumed)[0]):
        assert x.device.type == "cuda" and torch.equal(x, y)


@pytest.mark.parametrize("kind", ["plate_k", "t_chain"])
def test_planned_scan_steps_on_the_card(card, monkeypatch, kind):
    """``scan_steps`` and ``vmap_runs`` of a planned step at world size 1
    (NCCL, a TCP store on 127.0.0.1): small grouped MovieLens under
    ``{"plate_1": "p"}`` + all K through the lowrank kernels, and small
    covid under ``{"nDs": "t"}`` (the T-sharded chain): ELBOs and state
    bitwise the eager planned loop's, launches recorded into the graph."""
    import socket
    import torch.distributed as dist
    from alan_tpu_torch.models import covid
    from alan_tpu_torch.parallel import distributed
    from alan_tpu_torch.parallel.mesh import MeshPlan, make_mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.initialize(f"tcp://127.0.0.1:{port}", 1, 0, device_type="cuda")
    try:
        if kind == "plate_k":
            monkeypatch.setenv("ALAN_TPU_LOWRANK_MIN", "1")
            monkeypatch.setenv("ALAN_TPU_LAZY_LOWRANK", "1")
            ps, data, cov = tml.load_data_covariates(seed=3, M=20, N=5, device=card)
            plan = MeshPlan(make_mesh({"k": 1, "p": 1}, device_type="cuda"),
                            {"plate_1": "p"}).with_all_K("k")
            step, state0 = train.qem(tml.grouped_problem(ps, data, cov, device=card), 30,
                                     device=card, mesh_plan=plan)
            counter = lambda: tk.FWD_LAUNCHES
        else:
            ps, _, data, _, cov, _ = covid.load_data_covariates(seed=0, nRs=4, nDs=16,
                                                                device=card)
            plan = MeshPlan(make_mesh({"t": 1}, device_type="cuda"), {"nDs": "t"})
            step, state0 = train.qem(covid.generate_problem(ps, data, cov, "qem", device=card),
                                     10, device=card, mesh_plan=plan)
            counter = lambda: 0
        n = 3
        st_e, el_e = train._eager(step, n, state0, torch.Generator(device=card).manual_seed(7))
        run = train.scan_steps(step, n)
        before = counter()
        st_s, el_s = run(state0, torch.Generator(device=card).manual_seed(7))
        assert run.capture_seconds > 0 and (kind != "plate_k" or counter() > before)
        assert torch.equal(el_s, el_e)
        for x, y in zip(train._flatten(st_s)[0], train._flatten(st_e)[0]):
            assert torch.equal(x, y)
        _, rows = train.vmap_runs(step, n, 2)(state0, 3)
        for r in range(2):
            _, e = train._eager(step, n, state0, train.run_generator(3, r, card))
            assert torch.equal(rows[r], e)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
