"""Dim-aware distribution wrapper (counterpart of
``alan_tpu/distributions/dimdist.py``).

``DimDist`` lets distribution parameters carry named dims (K-dims and plate
dims).  Sampling broadcasts new named dims onto the draw; ``log_prob`` aligns
the sample against the parameter dims, inserting singleton axes for
parameter dims absent from the sample.

Layout convention: a parameter prepared for its family is shaped
``(*arg_dim_sizes_or_1, *pad_1s, *own_batch, *own_event)`` so that all
parameters right-align on the broadcast batch block.
"""
from __future__ import annotations

import torch

from ..dims import DT, as_dt, unify_dims, expand_to, sum_pos, to_device
from .families import Family


class DimDist:
    def __init__(self, family: type[Family], **params):
        self.family = family
        params = {k: v for k, v in params.items() if v is not None}
        params = family.canonicalize(params)
        self.params = {k: as_dt(v) for k, v in params.items()}
        # python-number parameters become CPU tensors: put them beside the
        # others, so a constant argument works on any device (where every
        # parameter is a number, sample and log_prob move them to the
        # generator's or the sample's device)
        device = next((v.data.device for v in self.params.values()
                       if v.data.device.type != "cpu"), None)
        if device is not None:
            self.params = {k: DT(to_device(v.data, device), v.dims)
                           for k, v in self.params.items()}
        self.arg_dims = tuple(unify_dims(self.params.values()))

        self._arg_event = {k: family.arg_event_ndim.get(k, 0) for k in self.params}
        self._batch_ndims = {k: v.pos_ndim - self._arg_event[k]
                             for k, v in self.params.items()}
        self.batch_ndim = max(self._batch_ndims.values(), default=0)
        if self.batch_ndim < 0:
            raise ValueError("parameter has fewer positional axes than its event rank")

        batch_shapes = []
        for k, v in self.params.items():
            bnd = self._batch_ndims[k]
            batch_shapes.append(v.pos_shape[:bnd] if bnd > 0 else ())
        self.batch_shape = tuple(torch.broadcast_shapes(*batch_shapes)) \
            if batch_shapes else ()

        ev = family.event_ndim
        explicit = family.event_shape(params)
        if explicit is not None:
            self.event_shape = tuple(explicit)
        elif ev == 0:
            self.event_shape = ()
        else:
            cands = [v.pos_shape[len(v.pos_shape) - ev:]
                     for k, v in self.params.items() if self._arg_event[k] >= ev]
            self.event_shape = tuple(torch.broadcast_shapes(*cands))

        self._dim_sizes = {}
        for v in self.params.values():
            self._dim_sizes.update(v.dimsizes())

    def _prepared_params(self, n_pad: int, device):
        """Each param as a raw tensor (*arg_dims_or_1, *1s, *own_pos) on
        ``device`` whose batch block lines up with the target."""
        out = {}
        nd = len(self.arg_dims)
        for k, v in self.params.items():
            a = to_device(expand_to(v, self.arg_dims), device)
            pad = n_pad + (self.batch_ndim - self._batch_ndims[k])
            if pad > 0:
                a = a.reshape(tuple(a.shape[:nd]) + (1,) * pad + tuple(a.shape[nd:]))
            out[k] = a
        return out

    def sample(self, generator, reparam: bool, sample_dims,
               dim_sizes: dict[str, int], sample_shape=(), noise=None) -> DT:
        """Draw with all named dims in ``sample_dims`` on the result;
        ``dim_sizes`` gives sizes for dims not already on the parameters.
        ``noise``, a DT with the draw's dims and shape (or a tensor laid
        out as the draw: its new dims, the parameters' dims, then the
        positional axes), replaces the generator's standard noise of a
        reparameterised draw; a family whose noise holds more than one
        number per draw (``Family.noise_event``) takes those on its last
        axes."""
        sample_dims = list(sample_dims)
        if len(set(sample_dims)) != len(sample_dims):
            raise ValueError(f"duplicate sample_dims {sample_dims}")
        if not set(self.arg_dims).issubset(sample_dims):
            raise ValueError(f"sample_dims {sample_dims} must include arg dims {self.arg_dims}")
        if reparam and not self.family.has_rsample:
            raise ValueError(
                f"Trying to do reparameterised sampling of {self.family.name}, "
                f"which has no reparameterised sampler (likely a discrete distribution).")

        extra = [d for d in sample_dims if d not in self.arg_dims]
        sizes = {**self._dim_sizes, **{d: dim_sizes[d] for d in extra}}
        sample_shape = tuple(sample_shape)
        full = (tuple(sizes[d] for d in extra)
                + tuple(sizes[d] for d in self.arg_dims)
                + sample_shape + tuple(self.batch_shape) + tuple(self.event_shape))
        out_dims = tuple(extra) + self.arg_dims
        if noise is None:
            params = self._prepared_params(len(sample_shape), generator.device)
            data = self.family.sample(generator, full, params)
        else:
            if not self.family.has_rsample:
                raise ValueError(f"{self.family.name} has no reparameterised draw "
                                 f"to take noise")
            eps = noise if isinstance(noise, DT) else DT(noise, out_dims)
            if set(eps.dims) != set(out_dims):
                raise ValueError(f"noise dims {eps.dims}, the draw's {out_dims}")
            eps = eps.with_dims_front(list(out_dims)).data
            want = full + tuple(self.family.noise_event)
            if tuple(eps.shape) != want:
                raise ValueError(f"noise shape {tuple(eps.shape)}, the draw's {want}")
            params = self._prepared_params(len(sample_shape), eps.device)
            data = self.family.from_noise(eps, params)
        out = DT(data, out_dims)
        if not reparam:
            out = DT(out.data.detach(), out.dims)
        return out

    def log_prob(self, x) -> DT:
        """Log-density of ``x``; result named dims = x.dims + arg_dims, the
        positional (sample_shape, batch) axes are summed."""
        x = as_dt(x)
        ev = self.family.event_ndim
        sample_ndim = x.pos_ndim - self.batch_ndim - ev
        if sample_ndim < 0:
            raise ValueError(
                f"sample for {self.family.name} has {x.pos_ndim} positional axes; "
                f"expected at least batch({self.batch_ndim}) + event({ev})")

        # Cross-K path (dimdist.py:125-139 of alan_tpu): when the sample and
        # the parameters carry disjoint K-dims an exp-family density
        # factorises into one batched matmul instead of an elementwise
        # evaluation over the whole K^2 * plate cross product; past the
        # lazy threshold the product is deferred to the K-contraction that
        # consumes it (ops/lowrank_kernel.py), so it is never materialised.
        from ..ops.lowrank import (LOWRANK_FAMILIES, lowrank_applicable,
                                   lowrank_logprob, lowrank_logprob_lazy,
                                   lowrank_lazy_preferred)
        if self.family.name in LOWRANK_FAMILIES and lowrank_applicable(
                self.family.name, x, self.params, self.arg_dims):
            if lowrank_lazy_preferred(x, self.params):
                return lowrank_logprob_lazy(self.family.name, x, self.params)
            return lowrank_logprob(self.family.name, x, self.params)

        union = unify_dims([x] + list(self.params.values()))
        nu = len(union)
        x_arr = expand_to(x, union)
        params = {}
        for k, v in self.params.items():
            a = to_device(expand_to(v, union), x_arr.device)
            pad = sample_ndim + (self.batch_ndim - self._batch_ndims[k])
            if pad > 0:
                a = a.reshape(tuple(a.shape[:nu]) + (1,) * pad + tuple(a.shape[nu:]))
            params[k] = a
        lp = self.family.log_prob(x_arr, params)
        return sum_pos(DT(lp, tuple(union)))
