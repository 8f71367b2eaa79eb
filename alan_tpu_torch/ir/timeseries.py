"""First-order Markov timeseries inside a plate (counterpart of
``alan_tpu/ir/timeseries.py``).

``Timeseries(init, trans)`` is a latent over the plate's dim T whose step t
is drawn from ``trans`` given the previous step (``prev`` in ``trans``'s
arguments); step 0 is conditioned on ``init``, a variable of the parent
plate.  ``log_prob`` returns a ``[T, Kinit, K]``-dimmed factor built from
the lagged sample in one shot; the contraction over T happens in
``logpq`` as a chain of log-space matmuls.

``sample`` draws the prior with one particle (``BoundPlate.sample``), as a
Python loop over T.  Drawing K > 1 particles, which ``alan_tpu`` permutes
between steps for a timeseries in Q, and ``sample_extended`` /
``predictive_ll`` (prediction beyond T) are not ported and raise.
"""
from __future__ import annotations

import torch

from ..dims import DT, as_dt, bind, expand_to, rename_dim
from .dist import _DistCall


class Timeseries:
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

    # -- sampling: the prior, one particle, a loop over T -----------------
    def sample(self, scope, generator, reparam, active_platedims, K_dim,
               dim_sizes) -> DT:
        assert len(active_platedims) >= 1
        other_platedims, T_dim = active_platedims[:-1], active_platedims[-1]
        if dim_sizes[K_dim] != 1:
            raise NotImplementedError(
                "drawing K > 1 particles of a Timeseries (a timeseries in Q) "
                "is not ported to alan_tpu_torch yet")
        prev = as_dt(scope[self.init])
        if set(prev.dims) != set([K_dim, *other_platedims]):
            raise Exception(
                f"Initial state {self.init} doesn't have the right dims for a "
                f"timeseries; it must be defined one step up the plate hierarchy "
                f"(got {prev.dims}, expected {[K_dim, *other_platedims]})")
        carry_dims = prev.dims

        static_scope, scanned = {}, {}
        for k, v in scope.items():
            v = as_dt(v)
            if T_dim in v.dims:
                scanned[k] = v.order(T_dim)          # (rem..., T, pos...)
            else:
                static_scope[k] = v

        steps = []
        for t in range(dim_sizes[T_dim]):
            scope_t = dict(static_scope)
            for k, o in scanned.items():
                scope_t[k] = DT(o.data.select(len(o.dims), t), o.dims)
            scope_t["prev"] = prev
            prev = self.trans.sample(scope_t, generator, reparam, other_platedims,
                                     K_dim, dim_sizes).with_dims_front(carry_dims)
            steps.append(prev.data)
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

    def sample_extended(self, *args, **kwargs):
        raise NotImplementedError(
            "Timeseries.sample_extended is not ported to alan_tpu_torch yet "
            "(ROADMAP queue 1 item 4)")

    def predictive_ll(self, *args, **kwargs):
        raise NotImplementedError(
            "Timeseries.predictive_ll is not ported to alan_tpu_torch yet "
            "(ROADMAP queue 1 item 4)")
