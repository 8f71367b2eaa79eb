"""User-facing distribution atoms of the model IR (counterpart of
``alan_tpu/ir/dist.py``).

A distribution argument may be
  * a number or a torch tensor (constant),
  * a string (reference to a variable in scope),
  * a lambda (transformation of scope variables; args matched by name),
  * an ``OptParam`` / ``QEMParam`` (learnable; resolved through the parameter
    state that BoundPlate threads through the scope).

``Normal(0., 1.)`` etc. construct lazy ``_DistCall`` objects that ``Plate``
finalizes with the variable name.
"""
from __future__ import annotations

import types

import torch

from ..dims import DT, as_dt, bind, dims_of, expand_to, slice_dim
from ..utils import Number, function_arguments
from ..distributions.families import FAMILIES, Family
from ..distributions.dimdist import DimDist
from .param import Param, OptParam, QEMParam
from .data import Data


def datagroup(group: dict) -> bool:
    """True if this (singleton) group is a Data marker."""
    assert isinstance(group, dict)
    hasdata = any(isinstance(v, Data) for v in group.values())
    assert not (len(group) >= 2 and hasdata)
    return hasdata


class _DistCall:
    """Lazy user-level distribution: ``Normal(0., 'a')`` before it is bound
    to a variable name inside a Plate/Group."""
    family: type[Family]

    def __init__(self, *args, sample_shape=(), **kwargs):
        self.args = args
        self.kwargs = kwargs
        self.sample_shape = (tuple(sample_shape) if not isinstance(sample_shape, int)
                             else (sample_shape,))

    def finalize(self, varname):
        return Dist(varname=varname, family=self.family, args=self.args,
                    sample_shape=self.sample_shape, kwargs=self.kwargs)


class Dist:
    """A finalized distribution node."""

    def __init__(self, varname, family, args, sample_shape, kwargs):
        self.varname = varname
        self.family = family
        self.sample_shape = tuple(sample_shape)
        self.using_sample_shape = self.sample_shape != ()

        bound = family.bind_args(args, kwargs)

        self.qem_dist = any(isinstance(v, QEMParam) for v in bound.values())
        self.opt_dist = any(isinstance(v, OptParam) for v in bound.values())

        if (self.qem_dist or self.opt_dist) and self.using_sample_shape:
            raise Exception("You can't use sample_shape with QEM or Opt parameters")

        if self.qem_dist:
            vals = list(bound.values())
            for v in vals:
                if not isinstance(v, QEMParam):
                    raise Exception(
                        "If one parameter on a distribution is a QEMParam, all "
                        "parameters on that distribution must be QEMParams")
            ig0 = set(vals[0].ignore_platenames)
            for v in vals[1:]:
                if ig0 != set(v.ignore_platenames):
                    raise Exception("All QEMParams on a distribution must share ignore_platenames")

        # Param -> named string reference saved in opt_qem_params
        self.opt_qem_params = {}   # paramname -> (distargname, Param)
        resolved = {}
        for distargname, v in bound.items():
            if isinstance(v, Param):
                if varname is None:
                    raise Exception("You can't use QEMParam / OptParam in a timeseries at present")
                name = v.name if v.name is not None else f"{varname}_{distargname}"
                self.opt_qem_params[name] = (distargname, v)
                v = name
            resolved[distargname] = v

        self.str_args = {}
        self.func_args = {}
        self.tensor_args = {}
        self.val_args = {}
        all_args = set()
        for distargname, v in resolved.items():
            if isinstance(v, str):
                self.str_args[distargname] = v
                all_args.add(v)
            elif isinstance(v, types.FunctionType):
                self.func_args[distargname] = v
                all_args.update(function_arguments(v))
            elif isinstance(v, (DT, torch.Tensor)):
                self.tensor_args[distargname] = as_dt(v)
            else:
                assert isinstance(v, Number), f"bad arg {distargname}={v!r}"
                self.val_args[distargname] = v
        self.all_args = list(all_args)

    def to(self, device):
        """Move the constant tensor arguments to ``device`` (in place)."""
        self.tensor_args = {k: DT(v.data.to(device), v.dims)
                            for k, v in self.tensor_args.items()}

    def paramname2val(self, scope):
        result = {}
        for k, v in self.val_args.items():
            result[k] = float(v) if not self.family.discrete else v
        for k, v in self.tensor_args.items():
            result[k] = v
        for k, ref in self.str_args.items():
            result[k] = scope[ref]
        for k, f in self.func_args.items():
            val = f(*[scope[a] for a in function_arguments(f)])
            if not isinstance(val, (DT, torch.Tensor, Number)):
                raise Exception("Lambda on a distribution returned a non-tensor")
            result[k] = val
        return result

    def tdd(self, scope) -> DimDist:
        return DimDist(self.family, **self.paramname2val(scope))

    def sample(self, scope, generator, reparam, active_platedims, K_dim,
               dim_sizes, noise=None) -> DT:
        return self.tdd(scope).sample(
            generator, reparam,
            sample_dims=[*active_platedims, K_dim],
            dim_sizes=dim_sizes,
            sample_shape=self.sample_shape,
            noise=noise,
        )

    def log_prob(self, sample, scope):
        return self.tdd(scope).log_prob(sample)

    def filter_scope(self, scope):
        return {k: v for k, v in scope.items() if k in self.all_args}

    def prior_draw(self, scope, keygen, noise, sample_dims, dim_sizes) -> DT:
        """One draw, not reparameterised, over ``sample_dims``.  Its
        standard noise is the next tensor of the iterator ``noise`` (laid
        out as the draw: its new dims, the parameters' dims, then the
        positional axes) where one is given and the family has a
        reparameterised form; else the draw takes ``keygen()``'s
        generator."""
        tdd = self.tdd(scope)
        if noise is not None and self.family.has_rsample:
            eps = next(noise, None)
            if eps is None:
                raise ValueError("the injected standard-normal noise ran out "
                                 "before the draws did")
            return tdd.sample(None, False, sample_dims, dim_sizes,
                              sample_shape=self.sample_shape, noise=eps)
        return tdd.sample(keygen(), False, sample_dims, dim_sizes,
                          sample_shape=self.sample_shape)

    def sample_extended(self, sample, name, scope, inputs_params,
                        original_platedims, extended_platedims,
                        active_extended_platedims, Ndim, keygen,
                        original_data, noise=None):
        """A draw from the prior over the extended plates (``prior_draw``)
        whose original region holds the posterior sample (a latent) or the
        training data (a data variable)."""
        original_sample = as_dt(sample if sample is not None else original_data[name])
        extended = self.prior_draw(self.filter_scope(scope), keygen, noise,
                                   [*active_extended_platedims, Ndim],
                                   extended_platedims)

        # overwrite the original region (out of place: a copy of the draw)
        shared = [d for d in extended.dims
                  if d in original_platedims and d in dims_of(original_sample)]
        ext_o = extended.order(*shared)       # dims rest, pos (*shared, *pos)
        orig_arr = expand_to(original_sample.order(*shared), ext_o.dims)
        idx = (tuple(slice(None) for _ in ext_o.dims)
               + tuple(slice(0, original_platedims[d]) for d in shared))
        new_data = ext_o.data.clone()
        new_data[idx] = orig_arr.to(new_data.dtype)
        return bind(DT(new_data, ext_o.dims), *shared)

    def predictive_ll(self, sample, name, scope, inputs_params,
                      original_platedims, extended_platedims,
                      original_data, extended_data):
        """``(original_ll, extended_ll)``: the log-likelihood of the
        extended data, and its restriction to the original plate region."""
        original_ll, extended_ll = {}, {}
        if name in extended_data:
            ell = self.log_prob(extended_data[name], scope)
            extended_ll[name] = ell
            oll = ell
            for d in dims_of(ell):
                if d in original_platedims:
                    oll = slice_dim(oll, d, 0, original_platedims[d])
            original_ll[name] = oll
        return original_ll, extended_ll


def sample_gdt(prog: dict, scope: dict, keygen, active_platedims, K_dim,
               groupvarname2Kdim, dim_sizes, sampler, reparam, noise=None) -> dict:
    """Sample a group/dist/timeseries sharing one K-dim; ``noise`` maps a
    variable name to the standard noise of its reparameterised draw.  A
    group that holds a Timeseries with K > 1 particles draws the sampler's
    permutation over the K-dim and the plates (the timeseries' T among
    them), which reorders each step's particles before the next step."""
    assert not datagroup(prog)

    set_all_args = set(a for dist in prog.values() for a in dist.all_args)
    all_args = set_all_args.difference([*prog.keys(), "prev"])

    for k in all_args:
        if k not in scope:
            raise Exception(f"{k} is not in scope")

    scope = {k: v for k, v in scope.items() if k in all_args}
    scope = sampler.resample_scope(scope, active_platedims, K_dim, dim_sizes, keygen)

    timeseries_perm = None
    if dim_sizes[K_dim] > 1 and any(getattr(d, "is_timeseries", False)
                                    for d in prog.values()):
        timeseries_perm = sampler.perm(dims=[K_dim, *active_platedims], Kdim=K_dim,
                                       dim_sizes=dim_sizes, generator=keygen())

    result = {}
    for name, dist in prog.items():
        kw = {}
        if noise is not None:
            if not isinstance(dist, Dist):
                raise NotImplementedError(
                    f"{name}: only a distribution's draw takes injected noise")
            kw["noise"] = noise[name]
        if getattr(dist, "is_timeseries", False):
            kw["timeseries_perm"] = timeseries_perm
        s = dist.sample(scope, None if noise is not None else keygen(), reparam,
                        active_platedims, K_dim, dim_sizes, **kw)
        scope[name] = s
        result[name] = s
    return result


# ---- family table: one user-facing constructor per family ----------------

def new_dist(name: str, family: type[Family]):
    """Register a user-facing distribution class for ``family``."""
    DC = type(name, (_DistCall,), {"family": family})
    globals()[name] = DC
    _dist_calls[name] = DC
    return DC


_dist_calls: dict[str, type] = {}
for _name, _fam in FAMILIES.items():
    new_dist(_name, _fam)
