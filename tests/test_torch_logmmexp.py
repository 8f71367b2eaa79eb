"""The port's log-space matmuls (``ops/logmmexp.py`` and the plain versions
of its two kernels) against ``alan_tpu``'s.

Inputs come from numpy seeds; the port runs on the CPU.

* ``logmmexp`` against ``alan_tpu.ops.logmmexp.logmmexp(allow_pallas=False)``
  and ``logmmexp_pallas(interpret=True)``: rtol/atol 1e-5, as
  ``tests/test_ops.py``;
* ``chain_logmmexp`` (the small-K route and the dense route) against
  ``alan_tpu``'s dense ``chain_logmmexp`` and ``chain_logmmexp_lanes`` in
  interpret mode, on the shapes of ``tests/test_ops.py:176-222`` (odd T,
  K=2, K=33, extra batch dims, -inf entries): values 1e-5; gradients rtol
  1e-4 / atol 1e-5 against the dense path and 3e-3 / 1e-5 against the lanes
  path, as ``tests/test_ops.py:211``;
* the fused kernel's pre-pass (``reference_prepass``): maxes, TF32 hi/lo
  parts whose sum gives ``exp(x - max) * 2**SCALE_BITS`` to 2^-21, B
  transposed, padding zeroed, -inf rows and columns; the emulation of its
  product kernel (3xTF32 in fresh sums of ``BK`` k, rounded toward zero
  like the tensor cores) against ``logmmexp(allow_pallas=False)`` and
  ``logmmexp_pallas(interpret=True)``: rtol/atol 1e-5; the tile width the
  host picks;
* the routing rules and the wrappers' refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alan_tpu.ops.logmmexp import chain_logmmexp as j_chain
from alan_tpu.ops.logmmexp import logmmexp as j_logmmexp
from alan_tpu.ops.pallas_logmmexp import logmmexp_pallas as j_logmmexp_pallas
from alan_tpu.ops.pallas_smallk import chain_logmmexp_lanes as j_chain_lanes
from alan_tpu_torch.ops import logmmexp as tlm
from alan_tpu_torch.ops import logmmexp_kernel as tlk
from alan_tpu_torch.ops import smallk_kernel as tsk
from test_torch_harness import Env

DENSE_CHAIN = dict(ALAN_TPU_NO_SMALLK_CHAIN=1)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# ---- logmmexp -------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 6, 8, 5), (2, 40, 130, 17), (1, 64, 200, 64)])
def test_logmmexp_matches_jax(shape):
    """K = 8 takes the dense route, K >= 128 the fused kernel's plain version."""
    b, M, K, N = shape
    rng = np.random.default_rng(K)
    A = (rng.standard_normal((b, M, K)) * 3).astype(np.float32)
    B = (rng.standard_normal((b, K, N)) * 3).astype(np.float32)
    A[0, 1] = -np.inf                       # a row with no mass
    B[-1, :, 2] = -np.inf                   # a column with no mass
    got = tlm.logmmexp(_t(A), _t(B)).numpy()
    want = np.asarray(j_logmmexp(jnp.asarray(A), jnp.asarray(B), allow_pallas=False))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if K >= 128:
        fused = np.asarray(j_logmmexp_pallas(jnp.asarray(A), jnp.asarray(B),
                                             interpret=True))
        np.testing.assert_allclose(got, fused, rtol=1e-5, atol=1e-5)


def test_fused_gradient_matches_jax():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((2, 12, 130)).astype(np.float32)
    B = rng.standard_normal((2, 130, 9)).astype(np.float32)
    W = rng.standard_normal((2, 12, 9)).astype(np.float32)
    gA, gB = jax.grad(lambda a, b: jnp.sum(j_logmmexp(a, b, allow_pallas=False) * W),
                      argnums=(0, 1))(jnp.asarray(A), jnp.asarray(B))
    tA, tB = _t(A, True), _t(B, True)
    (tlm.logmmexp(tA, tB) * _t(W)).sum().backward()
    np.testing.assert_allclose(tA.grad.numpy(), np.asarray(gA), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tB.grad.numpy(), np.asarray(gB), rtol=1e-4, atol=1e-5)


# ---- the fused kernel's pre-pass and product, in plain torch ---------------------

def _fused_input(shape, seed):
    """Operands with a -inf row of A and a -inf column of B."""
    b, M, K, N = shape
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((b, M, K)) * 3).astype(np.float32)
    B = (rng.standard_normal((b, K, N)) * 3).astype(np.float32)
    A[0, 1] = -np.inf
    B[-1, :, 2] = -np.inf
    return A, B


@pytest.mark.parametrize("bn", tlk.TILE_WIDTHS)
@pytest.mark.parametrize("shape", [(2, 70, 257, 65), (1, 130, 64, 129)])
def test_prepass_layout_and_exactness(shape, bn):
    b, M, K, N = shape
    A, B = _fused_input(shape, 11)
    a_max, b_max, split = tlk.reference_prepass(_t(A), _t(B), bn)
    assert split.numel() == tlk.scratch_floats(b, M, K, N, bn)
    ah, al, bh, bl = tlk.split_parts(split, b, M, K, N, bn)
    mp, np_, kp = -(-M // tlk.BM) * tlk.BM, -(-N // bn) * bn, -(-K // tlk.BK) * tlk.BK
    assert ah.shape == al.shape == (b, mp, kp) and bh.shape == bl.shape == (b, np_, kp)
    for part in (ah, al, bh, bl):                 # TF32: the low 13 bits are 0
        assert not (part.view(torch.int32) & 0x1FFF).any()
    for part in (ah, al):                         # padding: rows past M, k past K
        assert not part[:, M:].any() and not part[:, :, K:].any()
    for part in (bh, bl):
        assert not part[:, N:].any() and not part[:, :, K:].any()
    a_want = np.where(np.isfinite(A.max(-1)), A.max(-1), 0)
    b_want = np.where(np.isfinite(B.max(-2)), B.max(-2), 0)
    np.testing.assert_array_equal(a_max.numpy(), a_want)
    np.testing.assert_array_equal(b_max.numpy(), b_want)
    assert a_max[0, 1] == 0 and b_max[-1, 2] == 0
    scale = 2.0 ** tlk.SCALE_BITS
    ea = np.exp(A - a_want[..., None].astype(np.float32)).astype(np.float64)
    eb = np.exp(B - b_want[:, None, :].astype(np.float32)).astype(np.float64)
    eb = eb.transpose(0, 2, 1)
    for (hi, lo), e, rows in (((ah, al), ea, M), ((bh, bl), eb, N)):
        got = (hi.double() + lo.double())[:, :rows, :K].numpy() / scale
        np.testing.assert_allclose(got, e, rtol=2.0 ** -21, atol=0)
    assert not ah[0, 1].any() and not bh[-1, 2].any()   # the -inf row and column


@pytest.mark.parametrize("shape", [(1, 64, 1000, 64), (2, 70, 257, 65)])
def test_emulated_product_matches_jax(shape):
    """The product kernel's arithmetic at its stage of BK = 32 k, from the
    pre-pass's plain version, at both tile widths."""
    b, M, K, N = shape
    A, B = _fused_input(shape, 12)
    want = np.asarray(j_logmmexp(jnp.asarray(A), jnp.asarray(B), allow_pallas=False))
    fused = np.asarray(j_logmmexp_pallas(jnp.asarray(A), jnp.asarray(B), interpret=True))
    for bn in tlk.TILE_WIDTHS:
        pre = tlk.reference_prepass(_t(A), _t(B), bn)
        got = tlk.emulate_product(*pre, b, M, K, N, bn).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, fused, rtol=1e-5, atol=1e-5)


def test_fresh_stage_sums_keep_f32_grade():
    """Why each stage of BK k starts a fresh tensor-core sum: with the sums
    rounded toward zero, one sum over all of K = 1000 drifts past 1e-5 from
    f64, fresh sums of 32 stay within the plain version's distance."""
    A, B = (_t(x) for x in _fused_input((1, 64, 1000, 64), 13))
    a_max, b_max = tlk._shifts(A.double(), B.double())
    exact = torch.log(torch.exp(A.double() - a_max) @ torch.exp(B.double() - b_max)
                      + tlk._TINY) + a_max + b_max
    finite = torch.isfinite(exact)
    plain = (tlk.reference_logmmexp(A, B).double() - exact)[finite].abs().max()
    pre = tlk.reference_prepass(A, B, 64)
    err = {chunk: (tlk.emulate_product(*pre, 1, 64, 1000, 64, 64, chunk).double()
                   - exact)[finite].abs().max() for chunk in (tlk.BK, 1024)}
    assert err[tlk.BK] <= 1.5 * plain and err[tlk.BK] < 1e-5 < err[1024]


@pytest.mark.parametrize("nb,M,N,sms,want", [
    (2, 1000, 1000, 132, 128),   # the AR(1) model's first level: 128 blocks
    (1, 1000, 1000, 132, 64),    # its top level: 128 blocks of 128 x 64
    (4, 128, 128, 132, 64),      # K = 128 with a batch
    (8, 1000, 1000, 132, 128),   # several waves either way
    (1, 100, 100, 132, 64),
])
def test_tile_width_by_shape(nb, M, N, sms, want):
    assert tlk.tile_n(nb, M, N, sms) == want


# ---- chain_logmmexp -------------------------------------------------------------

CHAIN_SHAPES = [
    (35, 5, 30),     # covid-like K, small batch, odd T
    (300, 4, 7),     # a batch that pads the TPU's lanes
    (130, 8, 2),     # K=2, power-of-two T
    (128, 3, 33),    # odd K
]


def _chain_input(shape, seed):
    B, T, K = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, K, K)) * 2 - 1).astype(np.float32)


@pytest.mark.parametrize("shape", CHAIN_SHAPES)
def test_chain_matches_jax_dense(shape):
    ms = _chain_input(shape, 0)
    want = np.asarray(j_chain(jnp.asarray(ms)))
    got = tlm.chain_logmmexp(_t(ms)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with Env(**DENSE_CHAIN):
        dense = tlm.chain_logmmexp(_t(ms)).numpy()
    np.testing.assert_allclose(dense, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", CHAIN_SHAPES[:2])
def test_chain_matches_jax_lanes_kernel(shape):
    ms = _chain_input(shape, 1)
    want = np.asarray(j_chain_lanes(jnp.asarray(ms), interpret=True))
    got = tlm.chain_logmmexp(_t(ms)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_chain_multi_batch_dims_and_inf():
    rng = np.random.default_rng(2)
    ms = rng.standard_normal((5, 7, 9, 13, 13)).astype(np.float32)
    ms[:, :, 2, :, 3] = -np.inf
    ms[:, :, 3, 1, :] = -np.inf
    want = np.asarray(j_chain(jnp.asarray(ms)))
    got = tlm.chain_logmmexp(_t(ms)).numpy()
    assert got.shape == want.shape == (5, 7, 13, 13)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_chain_gradient_matches_jax():
    """Against the dense path at 1e-4 / 1e-5 and the lanes kernel (interpret
    mode) at 3e-3 / 1e-5."""
    rng = np.random.default_rng(4)
    ms = (rng.standard_normal((40, 6, 11, 11)) * 2).astype(np.float32)
    W = rng.standard_normal((40, 11, 11)).astype(np.float32)
    g_dense = jax.grad(lambda m: jnp.sum(j_chain(m) * W))(jnp.asarray(ms))
    g_lanes = jax.grad(lambda m: jnp.sum(j_chain_lanes(m, True) * W))(jnp.asarray(ms))
    for env in ({}, DENSE_CHAIN):
        t = _t(ms, True)
        with Env(**env):
            (tlm.chain_logmmexp(t) * _t(W)).sum().backward()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_dense),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_lanes),
                                   rtol=3e-3, atol=1e-5)


def test_chain_of_large_k_takes_the_fused_route(monkeypatch):
    """K >= 128 above the small-K limit: every tree node goes to the fused
    kernel's wrapper (its plain version on the CPU), as at the AR(1) model's
    K = 1000."""
    calls = []
    orig = tlk.logmmexp_fused
    monkeypatch.setattr(tlm, "logmmexp_fused",
                        lambda A, B: calls.append(tuple(A.shape)) or orig(A, B))
    ms = _chain_input((1, 4, 130), 5)[0]
    got = tlm.chain_logmmexp(_t(ms)).numpy()
    assert calls == [(2, 130, 130), (1, 130, 130)]
    np.testing.assert_allclose(got, np.asarray(j_chain(jnp.asarray(ms))),
                               rtol=1e-5, atol=1e-5)


# ---- routing and refusals -------------------------------------------------------

@pytest.mark.parametrize("shape,dtype,env,want", [
    ((2, 4, 30, 30), torch.float32, {}, True),
    ((4, 30, 30), torch.float32, {}, True),            # no batch: still a chain
    ((2, 4, 101, 101), torch.float32, {}, False),    # K above the default 100
    ((2, 4, 100, 100), torch.float32, {}, True),       # K at the limit
    ((2, 4, 1, 1), torch.float32, {}, False),        # K = 1
    ((2, 1, 30, 30), torch.float32, {}, False),      # T = 1
    ((2, 4, 30, 30), torch.float64, {}, False),
    ((2, 4, 30, 30), torch.float32, {"ALAN_TPU_NO_SMALLK_CHAIN": 1}, False),
    ((2, 4, 300, 300), torch.float64, {"ALAN_TPU_SMALLK_CHAIN": 1}, True),
    ((2, 4, 30, 30), torch.float32,
     {"ALAN_TPU_SMALLK_CHAIN": 1, "ALAN_TPU_NO_SMALLK_CHAIN": 1}, False),
    ((2, 4, 30, 30), torch.float32, {"ALAN_TPU_SMALLK_CHAIN_MAX_K": 29}, False),
    ((2, 4, 30, 30), torch.float32, {"ALAN_TPU_SMALLK_CHAIN_MAX_K": 30}, True),
    ((2, 4, 120, 120), torch.float32, {"ALAN_TPU_SMALLK_CHAIN_MAX_K": 128}, True),
    ((2, 4, 5, 5), torch.float32,
     {"ALAN_TPU_SMALLK_CHAIN_MAX_K": 4, "ALAN_TPU_SMALLK_CHAIN": 1}, True),
])
def test_smallk_routing(shape, dtype, env, want):
    with Env(**env):
        assert tlm._use_smallk(torch.zeros(shape, dtype=dtype)) is want


@pytest.mark.parametrize("K,env", [
    (30, {}), (100, {}), (101, {}),
    (30, {"ALAN_TPU_SMALLK_CHAIN_MAX_K": 29}), (30, {"ALAN_TPU_SMALLK_CHAIN_MAX_K": 30}),
    (120, {"ALAN_TPU_SMALLK_CHAIN_MAX_K": 128}), (5, {"ALAN_TPU_NO_SMALLK_CHAIN": 1}),
])
def test_smallk_routing_matches_jax(K, env, monkeypatch):
    """The port's small-K decision is ``alan_tpu``'s wherever the TPU's own
    limits (a Pallas TPU backend, VMEM, 128 lanes of batch) are met: here
    they are declared met, and the batch fills the lanes."""
    import importlib
    jlm = importlib.import_module("alan_tpu.ops.logmmexp")
    jps = importlib.import_module("alan_tpu.ops.pallas_smallk")
    monkeypatch.setattr(jps, "have_pallas_tpu", lambda: True)
    monkeypatch.setattr(jps, "fits_vmem", lambda K, nB: True)
    shape = (128, 4, K, K)
    with Env(**env):
        want = jlm._use_smallk_lanes(jnp.zeros(shape, jnp.float32))
        assert tlm._use_smallk(torch.zeros(shape)) is want


def test_smallk_refuses_non_float32_when_forced():
    with Env(ALAN_TPU_SMALLK_CHAIN=1):
        with pytest.raises(TypeError, match="float32"):
            tlm.chain_logmmexp(torch.zeros((3, 4, 5, 5), dtype=torch.float64))


def test_kernel_launchers_refuse_cpu_tensors():
    """The launchers take CUDA tensors only: a CPU tensor is never handed to
    a kernel (the wrappers give it the plain version instead)."""
    x = torch.zeros((2, 4, 5, 5))
    with pytest.raises(ValueError, match="CUDA"):
        tsk._launch_fwd(x, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tsk._launch_bwd(x, torch.zeros((2, 2, 5, 5)), 1)
    with pytest.raises(ValueError, match="CUDA"):
        tlk._launch(torch.zeros((1, 3, 4)), torch.zeros((1, 4, 2)))
    counts = (tsk.FWD_LAUNCHES, tsk.BWD_LAUNCHES, tlk.LAUNCHES)
    tsk.logmmexp_segment(x, 2)
    tlk.logmmexp_fused(torch.zeros((1, 3, 4)), torch.zeros((1, 4, 2)))
    assert (tsk.FWD_LAUNCHES, tsk.BWD_LAUNCHES, tlk.LAUNCHES) == counts


# ---- the small-K launch plan ------------------------------------------------------

@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("T", [2, 3, 7, 8, 9, 15, 16, 17, 109])
def test_reference_segment_is_m_levels(T, m):
    """One launch's plain version (aligned segments of 2^m operators, each
    reduced on its own) is bitwise the m levels of the whole-chain tree,
    short last segment included; its gradient agrees at rtol 1e-6."""
    rng = np.random.default_rng(100 * T + m)
    for K in (2, 5):
        ms = (rng.standard_normal((3, T, K, K)) * 2 - 1).astype(np.float32)
        W = rng.standard_normal((3, -(-T // 2 ** m), K, K)).astype(np.float32)
        x, xs = _t(ms, True), _t(ms, True)
        got = tsk.reference_segment(x, m)
        want = xs
        for _ in range(m):
            if want.shape[1] > 1:
                want = tsk.reference_level(want)
        assert got.shape == want.shape == W.shape
        assert torch.equal(got, want)
        (g_got,) = torch.autograd.grad((got * _t(W)).sum(), [x])
        (g_want,) = torch.autograd.grad((want * _t(W)).sum(), [xs])
        np.testing.assert_allclose(g_got.numpy(), g_want.numpy(), rtol=1e-6, atol=0)


def test_launch_plan():
    """Covid's chain (T = 109, K = 30) takes three launches of the kernels,
    109 -> 14 -> 2 -> 1, at the largest m whose backward fits two blocks on
    an SM; K = 100 and K = 128 fit one level a launch; K = 129 raises."""
    assert tsk.launch_plan(109, 30) == [3, 3, 1]
    sizes, n = [109], 109
    for m in tsk.launch_plan(109, 30):
        n = tsk.reference_segment(torch.zeros((1, n, 1, 1)), m).shape[1]
        sizes.append(n)
    assert sizes == [109, 14, 2, 1]
    two = 2 * (tsk.segment_smem(30, 3, True, 0) + tsk.SMEM_RESERVED)
    assert tsk.layout_for(30, 3, True) == tsk.layout_for(30, 3, False) == 0
    assert two <= tsk.SMEM_PER_SM < 2 * (tsk.segment_smem(30, 4, True, 0) + tsk.SMEM_RESERVED)
    assert tsk.launch_plan(9, 45) == [2, 2]              # m differs from covid's
    for K in (100, 128):
        assert tsk.launch_plan(7, K) == [1, 1, 1]
        layout = tsk.layout_for(K, 1, True)
        assert tsk.segment_smem(K, 1, True, layout) <= tsk.SMEM_PER_BLOCK
    assert tsk.layout_for(128, 1, True) == 1             # no room to stage
    assert tsk.launch_plan(8, 2) == [3] and tsk.launch_plan(1, 30) == []
    with pytest.raises(ValueError, match="K=129"):
        tsk.launch_plan(4, 129)


def test_fixup_layouts_fit_every_launch_the_plan_picks():
    """The joint-shift fix-ups' shared memory (ops/smallk_kernel.py's
    mirror of smallk_logmmexp.cu's layouts) stays within a block's 227 KB
    at every (K, m) the launch plan picks for K <= 128, keeping the
    backward's records in shared memory for K <= 89; at covid's (30, 3) the
    forward stages its segment and two of its blocks share an SM."""
    picked = {(K, m) for K in range(1, tsk.MAX_K + 1) for n in range(2, 70)
              for m in tsk.launch_plan(n, K)}
    for K, m in picked:
        for backward in (False, True):
            x0, rec, nbytes = tsk.fixup_layout(K, m, backward)
            assert 0 < nbytes <= tsk.SMEM_PER_BLOCK, (K, m, backward)
            assert nbytes == tsk.fixup_smem(K, m, backward)
            assert not backward or rec == (K <= 89), (K, m)
    x0, _, nbytes = tsk.fixup_layout(30, 3, False)
    assert x0 == 1 and 2 * (nbytes + tsk.SMEM_RESERVED) <= tsk.SMEM_PER_SM
    assert tsk.fixup_layout(30, 3, True)[:2] == (1, 1)


def test_smallk_chain_runs_the_launch_plan(monkeypatch):
    """On the CPU the small-K route runs the plan, one plain launch each."""
    calls = []
    orig = tsk.logmmexp_segment
    monkeypatch.setattr(tsk, "logmmexp_segment",
                        lambda x, m: calls.append((tuple(x.shape), m)) or orig(x, m))
    ms = _chain_input((6, 109, 30), 7)
    got = tlm.chain_logmmexp(_t(ms)).numpy()
    assert calls == [((6, 109, 30, 30), 3), ((6, 14, 30, 30), 3), ((6, 2, 30, 30), 1)]
    np.testing.assert_allclose(got, np.asarray(j_chain(jnp.asarray(ms))),
                               rtol=1e-5, atol=1e-5)


def test_level_layout_and_remainder():
    """One level of (nB, n, K, K): pairs (2l, 2l+1), the odd remainder
    carried to the end."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 4, 4)).astype(np.float32)
    out = tsk.reference_level(_t(x)).numpy()
    assert out.shape == (3, 3, 4, 4)
    np.testing.assert_array_equal(out[:, 2], x[:, 4])
    want = np.asarray(j_logmmexp(jnp.asarray(x[:, 2]), jnp.asarray(x[:, 3]),
                                 allow_pallas=False))
    np.testing.assert_allclose(out[:, 1], want, rtol=1e-5, atol=1e-5)


# ---- what the fused route's fix-ups keep for the backward --------------------------

@pytest.mark.parametrize("nb,M,N", [(2, 70, 45), (1, 64, 32), (3, 1, 97)])
def test_fused_fixup_masks_pack_the_flags(nb, M, N):
    """The kept masks against the flags bit by bit: by row, bit c of word
    [b, i, J] is entry (b, i, 32 J + c); by column, bit r of word [b, j, I]
    is entry (b, 64 I + r, j); as many words as ``fixup_mask_words`` says,
    ragged edges included."""
    flags = torch.from_numpy(np.random.default_rng(nb * M + N).random((nb, M, N)) < 0.3)
    rows, cols = tlk.fixup_masks(flags)
    mt, nt = tlk.fixup_tiles(M, N)
    assert rows.shape == (nb, M, nt) and cols.shape == (nb, N, mt)
    assert rows.numel() == tlk.fixup_mask_words(nb, M, N, False)
    assert cols.numel() == tlk.fixup_mask_words(nb, M, N, True)
    f = flags.numpy()
    for b in range(nb):
        for i in range(M):
            for J in range(nt):
                want = sum(1 << c for c in range(32) if 32 * J + c < N and f[b, i, 32 * J + c])
                assert int(rows[b, i, J]) & 0xFFFFFFFF == want
        for j in range(N):
            for I in range(mt):
                want = sum(1 << r for r in range(64) if 64 * I + r < M and f[b, 64 * I + r, j])
                assert int(cols[b, j, I]) & 0xFFFFFFFFFFFFFFFF == want


def test_plain_fixup_backward_from_kept_state_matches_joint_values():
    """The records the forward fix-up keeps (its plain version) hold each
    flagged entry's first argmax and reference terms, and the backward
    built from them alone gives the gradients of ``_JointValues``' backward
    for those entries (rtol 1e-5), with 0 from an entry whose terms are all
    -inf; the other entries' records stay 0."""
    rng = np.random.default_rng(21)
    x = rng.normal(0, 1, (2, 3, 40))
    d = (x[:, 1, None, :] - x[:, 0, :, None]) / 0.05
    A = torch.from_numpy((-0.5 * d * d).astype(np.float32))                 # (2, 40, 40)
    B = torch.from_numpy((-0.5 * ((x[:, 2, None, :] - x[:, 1, :, None]) / 0.05) ** 2)
                         .astype(np.float32))[:, :, :23]                      # (2, 40, 23)
    A[1, 5] = -np.inf
    a_max, b_max = tlk._shifts(A, B)
    flags = torch.matmul(torch.exp(A - a_max), torch.exp(B - b_max)) < tlk.JOINT_BELOW
    assert 0 < int(flags.sum()) < flags.numel()
    rec = tlk.reference_fixup_state(A, B, flags)
    t = rec[..., 3].contiguous().view(torch.int32).long()
    m, want_t = (A[:, :, :, None] + B[:, None, :, :]).max(2)
    fin = torch.isfinite(m) & flags
    assert torch.equal(t[fin], want_t[fin]) and bool((rec[~flags] == 0).all())
    assert torch.equal(rec[..., 0][fin], A.gather(2, want_t)[fin])
    assert bool((rec[..., 2][flags & ~torch.isfinite(m)] == -np.inf).all())
    g = torch.from_numpy(rng.standard_normal((2, 40, 23)).astype(np.float32))
    dA, dB = tlk.reference_fixup_bwd(A, B, g, rec, flags)
    a, b = A.clone().requires_grad_(True), B.clone().requires_grad_(True)
    vals, finite = tlk._JointValues.apply(a, b)
    want_dA, want_dB = torch.autograd.grad((vals * torch.where(flags & finite, g, 0.0)).sum(),
                                           [a, b])
    assert bool(torch.isfinite(dA).all()) and bool((dA[1, 5] == 0).all())
    torch.testing.assert_close(dA, want_dA, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dB, want_dB, rtol=1e-5, atol=1e-6)
