"""First-order Markov timeseries inside a plate (counterpart of
``alan_tpu/ir/timeseries.py``).

``Timeseries(init, trans)`` is a latent over the plate's dim T whose step t
is drawn from ``trans`` given the previous step (``prev`` in ``trans``'s
arguments); step 0 is conditioned on ``init``, a variable of the parent
plate.  ``log_prob`` returns a ``[T, Kinit, K]``-dimmed factor built from
the lagged sample in one shot; the contraction over T happens in
``logpq`` as a chain of log-space matmuls.

``sample`` draws K particles as a Python loop over T.  In Q, with K > 1,
the particles of step t are permuted (``sample_gdt``'s per-step
permutation) before they condition step t + 1, as ``alan_tpu`` does.
``sample_extended`` rolls the chain forward from the last posterior state
over an extended T, indexing the extended inputs at the absolute step.
"""
from __future__ import annotations

import torch

from ..dims import DT, as_dt, bind, concat_dim, dt_index, expand_to, rename_dim
from ..reduce_ks import _index_dim_int
from .dist import _DistCall


class Timeseries:
    is_timeseries = True
    qem_dist = False

    def __init__(self, init, trans):
        if not isinstance(init, str):
            raise Exception(
                "the first / `init` argument of a Timeseries should be a string "
                "naming a variable in the parent plate")
        if not isinstance(trans, _DistCall):
            raise Exception("the second / `trans` argument of a Timeseries should be a distribution")
        if trans.sample_shape != ():
            raise Exception("sample_shape must not be set on the transition distribution")

        self.init = init
        self.trans = trans.finalize(None)
        assert not self.trans.qem_dist
        # includes own-name/prev refs; stripped by sample_gdt
        self.all_args = [init, *self.trans.all_args]

    @property
    def opt_qem_params(self):
        return self.trans.opt_qem_params

    def to(self, device):
        self.trans.to(device)

    # -- sampling: a loop over T ----------------------------------------
    def sample(self, scope, generator, reparam, active_platedims, K_dim,
               dim_sizes, timeseries_perm=None) -> DT:
        """K particles of the chain; ``timeseries_perm`` (plate dims, T
        among them, and a positional K axis) permutes step t's particles
        before they condition step t + 1."""
        assert len(active_platedims) >= 1
        other_platedims, T_dim = active_platedims[:-1], active_platedims[-1]
        prev = as_dt(scope[self.init])
        if set(prev.dims) != set([K_dim, *other_platedims]):
            raise Exception(
                f"Initial state {self.init} doesn't have the right dims for a "
                f"timeseries; it must be defined one step up the plate hierarchy "
                f"(got {prev.dims}, expected {[K_dim, *other_platedims]})")
        carry_dims = prev.dims
        static_scope, scanned = _split_scope(scope, T_dim)
        perm = None
        if timeseries_perm is not None and T_dim in timeseries_perm.dims:
            perm = timeseries_perm.order(T_dim)     # (plates..., T, K)

        steps = []
        for t in range(dim_sizes[T_dim]):
            scope_t = _scope_at(static_scope, scanned, t)
            scope_t["prev"] = prev
            s = self.trans.sample(scope_t, generator, reparam, other_platedims,
                                  K_dim, dim_sizes).with_dims_front(carry_dims)
            steps.append(s.data)
            if perm is not None:
                p = DT(perm.data.select(len(perm.dims), t), perm.dims)
                s = bind(dt_index(s, K_dim, p), K_dim).with_dims_front(carry_dims)
            prev = s
        return DT(torch.stack(steps, 0), (T_dim,) + carry_dims)

    # -- log prob: lagged tensor, [T, Kinit, K] factor --------------------
    def log_prob(self, sample, scope, T_dim, K_dim):
        """Returns (lp, Kinit_dim); lp carries Kinit, K and T dims."""
        assert T_dim is not None and K_dim is not None
        sample = as_dt(sample)
        sdims = set(sample.dims)
        assert K_dim in sdims and T_dim in sdims

        initial_state = as_dt(scope[self.init])
        idims = set(initial_state.dims)
        assert T_dim not in idims
        diff = list(idims.difference(sdims))
        assert len(diff) == 1, f"couldn't infer Kinit dim: {diff}"
        Kinit_dim = diff[0]

        # lagged sample: [init, x_0, ..., x_{T-2}] labelled with Kinit
        o = rename_dim(sample, K_dim, Kinit_dim).order(T_dim)   # (rem..., T, pos...)
        ax = len(o.dims)
        body = o.data.narrow(ax, 0, o.data.shape[ax] - 1)
        init_arr = expand_to(initial_state, o.dims).unsqueeze(ax)
        init_arr = torch.broadcast_to(
            init_arr, body.shape[:ax] + (1,) + body.shape[ax + 1:])
        lagged = bind(DT(torch.cat([init_arr, body], dim=ax), o.dims), T_dim)

        lp = self.trans.log_prob(sample, {**scope, "prev": lagged})
        lpd = set(lp.dims)
        assert Kinit_dim in lpd and K_dim in lpd and T_dim in lpd
        return lp, Kinit_dim

    # -- prior roll-forward beyond T (prediction) -------------------------
    def sample_extended(self, sample, name, scope, inputs_params,
                        original_platedims, extended_platedims,
                        active_extended_platedims, Ndim, keygen, original_data,
                        noise=None):
        """Roll the transition forward from the last posterior state over
        the extended steps, indexing the extended inputs at the absolute
        step ``orig_T + t``; each step's draw as ``Dist.prior_draw``."""
        active_plates, T_dim = active_extended_platedims[:-1], active_extended_platedims[-1]
        orig_T, ext_T = original_platedims[T_dim], extended_platedims[T_dim]
        sample = as_dt(sample)
        if ext_T == orig_T:
            return sample

        prev = _index_dim_int(sample, T_dim, orig_T - 1)
        carry_dims = prev.dims
        static_scope, scanned = _split_scope(scope, T_dim)
        steps = []
        for t in range(orig_T, ext_T):
            scope_t = _scope_at(static_scope, scanned, t)
            scope_t["prev"] = prev
            prev = self.trans.prior_draw(scope_t, keygen, noise,
                                         [*active_plates, Ndim], extended_platedims
                                         ).with_dims_front(carry_dims)
            steps.append(prev.data)
        so = sample.order(T_dim)
        old = DT(torch.movedim(so.data, len(so.dims), 0), (T_dim,) + so.dims)
        return concat_dim([old, DT(torch.stack(steps, 0), (T_dim,) + carry_dims)],
                          T_dim)

    def predictive_ll(self, sample, name, scope, inputs_params,
                      original_platedims, extended_platedims,
                      original_data, extended_data):
        """A timeseries latent is no data variable: nothing to score."""
        return {}, {}


def _split_scope(scope, T_dim):
    """(the scope's values without T, {name: value ordered with T the first
    positional axis} for the values with T)."""
    static_scope, scanned = {}, {}
    for k, v in scope.items():
        v = as_dt(v)
        if T_dim in v.dims:
            scanned[k] = v.order(T_dim)             # (rem..., T, pos...)
        else:
            static_scope[k] = v
    return static_scope, scanned


def _scope_at(static_scope, scanned, t):
    """The scope of step ``t``: the values with T taken at ``t``."""
    scope_t = dict(static_scope)
    for k, o in scanned.items():
        scope_t[k] = DT(o.data.select(len(o.dims), t), o.dims)
    return scope_t
