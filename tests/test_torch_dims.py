"""The port's named-dim substrate and contraction steps against
``alan_tpu``'s, on the same numpy inputs (the cases mirror
``tests/test_dims.py`` and ``tests/test_ops.py``).  Exact algebra, so the
tolerance is f32 rounding: rtol/atol 1e-5 unless a case says otherwise."""
import numpy as np
import pytest
import torch

import alan_tpu.dims as jd
import alan_tpu_torch.dims as td
from test_torch_harness import assert_dt_close, jax_dt, port_np

rng = np.random.default_rng(0)


def A(*shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def both(a, *dims):
    return jax_dt(a, *dims), td.DT(torch.as_tensor(a), dims)


def test_order_bind_roundtrip():
    j, t = both(A(3, 4, 5), "a", "b")
    o = t.order("a")
    assert o.dims == ("b",) and tuple(o.data.shape) == (4, 3, 5)
    np.testing.assert_array_equal(port_np(o), np.asarray(j.order("a").data))
    back = td.bind(o, "a")
    assert_dt_close(j, back, 0, 0)
    with pytest.raises(ValueError):
        td.bind(back, "a")


@pytest.mark.parametrize("op", ["add", "sub", "mul", "truediv", "pow"])
def test_elementwise_alignment(op):
    f = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
         "mul": lambda x, y: x * y, "truediv": lambda x, y: x / y,
         "pow": lambda x, y: x ** 2.0 + y}[op]
    jx, tx = both(A(3, 4, 7), "a", "b")       # pos (7,)
    jy, ty = both(A(5, 4, 2, 7) + 3.0, "c", "b")   # pos (2, 7)
    assert_dt_close(f(jx, jy), f(tx, ty), 1e-5, 1e-5)
    # python scalars on either side
    assert_dt_close(2.5 - jx * 0.5, 2.5 - tx * 0.5, 1e-6, 1e-6)


@pytest.mark.parametrize("case", ["vec_vec", "vec_vec_shared_only",
                                  "mat_vec", "vec_unnamed"])
def test_pos_op_matmul_semantics(case):
    """``@`` on the positional blocks: vector . vector goes through the
    einsum path, the other ranks through ``pos_op``."""
    jz, tz = both(A(3, 4, 18), "K", "p")
    if case == "vec_vec":
        jx, tx = both(A(4, 5, 18), "p", "q")
    elif case == "vec_vec_shared_only":
        jx, tx = both(A(3, 4, 18), "K", "p")
    elif case == "mat_vec":
        jz, tz = both(A(3, 6, 18), "K")          # pos (6, 18)
        jx, tx = both(A(4, 18), "p")
    else:
        v = A(18)
        jx, tx = jax_dt(v), torch.as_tensor(v)
    assert_dt_close(jz @ jx, tz @ tx, 1e-5, 1e-5)
    # gradients flow through either path
    tz = td.DT(tz.data.clone().requires_grad_(True), tz.dims)
    (g,) = torch.autograd.grad((tz @ tx).data.sum(), tz.data)
    assert g.shape == tz.data.shape and torch.isfinite(g).all()


def test_reductions():
    j, t = both(A(3, 4, 2), "a", "b")
    assert_dt_close(jd.sum_dims(j, ("a",)), td.sum_dims(t, ("a",)), 1e-6, 1e-6)
    assert_dt_close(jd.mean_dims(j, "b"), td.mean_dims(t, "b"), 1e-6, 1e-6)
    assert_dt_close(jd.logsumexp_dims(j, ("a", "b")),
                    td.logsumexp_dims(t, ("a", "b")), 1e-5, 1e-5)
    assert_dt_close(jd.logmeanexp_dims(j, ("a",)),
                    td.logmeanexp_dims(t, ("a",)), 1e-5, 1e-5)
    assert_dt_close(jd.sum_pos(j), td.sum_pos(t), 1e-5, 1e-5)
    # ignore_extra_dims
    assert_dt_close(jd.sum_dims(j, ("a", "z"), ignore_extra_dims=True),
                    td.sum_dims(t, ("a", "z"), ignore_extra_dims=True), 1e-6, 1e-6)


def test_logsumexp_finite_guard():
    """All--inf slices keep the finite-guarded max shift: log(eps)."""
    a = A(4, 3)
    a[:, 1] = -np.inf
    j, t = both(a, "K", "p")
    got = td.logsumexp_dims(t, "K")
    assert_dt_close(jd.logsumexp_dims(j, "K"), got, 1e-6, 1e-6)
    assert np.isfinite(port_np(got)).all()


def test_dt_index():
    j, t = both(A(5, 3), "K", "p")
    idx = np.array([4, 0, 2])
    out = td.dt_index(t, "K", td.DT(torch.as_tensor(idx), ("p",)))
    assert_dt_close(jd.dt_index(j, "K", jax_dt(idx, "p")), out, 0, 0)
    # permutation with a positional K axis (the resample_scope pattern)
    j, t = both(A(5, 2, 4), "K", "p")
    perm = np.argsort(rng.random((2, 5)), axis=-1)
    ref = jd.bind(jd.dt_index(j, "K", jax_dt(perm, "p")), "K2")
    got = td.bind(td.dt_index(t, "K", td.DT(torch.as_tensor(perm), ("p",))), "K2")
    assert_dt_close(ref, got, 0, 0)


def test_expand_to_and_align():
    j, t = both(A(3, 2), "K")
    assert tuple(td.expand_to(t, ("p", "K")).shape) == (1, 3, 2)
    with pytest.raises(KeyError):
        td.expand_to(t, ("p",))
    _, u = td.align(t, td.DT(torch.zeros(4), ("p",)))
    assert u == ("K", "p")


def test_grad_through_dt_ops():
    x0 = A(3, 4)
    x = torch.tensor(x0, requires_grad=True)
    out = td.logsumexp_dims(td.DT(x, ("a", "b")) * 2.0, ("a", "b")).data
    (g,) = torch.autograd.grad(out, x)
    w = np.exp(2 * x0 - (2 * x0).max())
    np.testing.assert_allclose(g.numpy(), 2 * w / w.sum(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", [
    (("K_x", "p"), (3, 4), ("K_x", "K_y", "p"), (3, 5, 4), ("K_x",)),
    (("K_x",), (3,), ("K_y",), (5,), ("K_x", "K_y")),
    (("K_x", "K_y"), (3, 5), ("K_y", "K_z"), (5, 7), ("K_y",)),
    (("p", "K_x"), (4, 3), ("K_x",), (3,), ("K_x",)),
    (("K_x", "p"), (3, 4), ("p",), (4,), ()),
    (("K_a", "K_b", "T"), (3, 3, 6), ("K_b", "T"), (3, 6), ("K_b",)),
])
def test_pairwise_contract_matches_jax(case):
    """The log-space matmul step the port takes for CUDA tensors, run here
    on CPU tensors against alan_tpu's (scale 15 as in test_ops.py)."""
    from alan_tpu.ops.contraction import pairwise_logsumexp_contract as jpc
    from alan_tpu_torch.ops.contraction import pairwise_logsumexp_contract as tpc
    ad, ash, bd, bsh, Ks = case
    ja, ta = both(A(*ash, scale=15), *ad)
    jb, tb = both(A(*bsh, scale=15), *bd)
    got = tpc(ta, tb, Ks)
    assert_dt_close(jpc(ja, jb, Ks), got, 1e-5, 1e-4)
    naive = td.logsumexp_dims(ta + tb, Ks, ignore_extra_dims=True)
    np.testing.assert_allclose(port_np(got, naive.dims), port_np(naive),
                               rtol=1e-5, atol=1e-4)


def test_reduce_ks_matches_jax():
    """A four-factor contraction planned by the native planner in both
    packages (same plan, same values)."""
    import alan_tpu.reduce_ks as jr
    import alan_tpu_torch.reduce_ks as tr
    spec = [(("K_a", "p"), (4, 3)), (("K_a", "K_b"), (4, 5)),
            (("K_b", "K_c", "p"), (5, 6, 3)), (("K_c",), (6,))]
    pairs = [both(A(*shp), *ds) for ds, shp in spec]
    Ks = ("K_a", "K_b", "K_c")
    jl = [p[0] for p in pairs]
    tl = [p[1] for p in pairs]
    assert jr._plan(jl, Ks) == tr._plan(tl, Ks)
    assert_dt_close(jr.reduce_Ks(jl, Ks), tr.reduce_Ks(tl, Ks), 1e-5, 1e-5)


def test_scalars_follow_the_tensors_device():
    """Python numbers (and the 0-d CPU tensors they become) combine with
    tensors on another device; the meta device stands in for CUDA here."""
    from alan_tpu_torch.distributions.dimdist import DimDist
    from alan_tpu_torch.distributions.families import Normal
    from alan_tpu_torch.ops.lowrank import lowrank_logprob_lazy
    meta = lambda *shape: torch.zeros(*shape, device="meta")
    x = td.DT(meta(3, 2), ("a",))
    assert (x + td.DT(2.0) - 1.5).data.device.type == "meta"
    assert (2.0 - x).data.device.type == "meta"
    lz = lowrank_logprob_lazy(
        "Normal", td.DT(meta(4, 3, 2), ("K_z", "p")),
        {"loc": td.DT(meta(5, 2), ("K_g",)), "scale": td.DT(meta(5, 2), ("K_g",))})
    lz = lz - 1.0 - 2.0 + td.DT(meta(4, 3), ("K_z", "p"))
    assert lz.x_side.data.device.type == "meta"
    assert lz.materialize().data.device.type == "meta"
    d = DimDist(Normal, loc=0.0, scale=td.DT(meta(3), ("K",)))
    assert d.log_prob(td.DT(meta(4), ("p",))).data.device.type == "meta"
