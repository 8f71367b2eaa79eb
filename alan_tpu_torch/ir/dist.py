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

from ..dims import DT, as_dt
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
               dim_sizes) -> DT:
        return self.tdd(scope).sample(
            generator, reparam,
            sample_dims=[*active_platedims, K_dim],
            dim_sizes=dim_sizes,
            sample_shape=self.sample_shape,
        )

    def log_prob(self, sample, scope):
        return self.tdd(scope).log_prob(sample)


def sample_gdt(prog: dict, scope: dict, keygen, active_platedims, K_dim,
               groupvarname2Kdim, dim_sizes, sampler, reparam) -> dict:
    """Sample a group/dist sharing one K-dim."""
    assert not datagroup(prog)

    set_all_args = set(a for dist in prog.values() for a in dist.all_args)
    all_args = set_all_args.difference([*prog.keys(), "prev"])

    for k in all_args:
        if k not in scope:
            raise Exception(f"{k} is not in scope")

    scope = {k: v for k, v in scope.items() if k in all_args}
    scope = sampler.resample_scope(scope, active_platedims, K_dim, dim_sizes, keygen)

    result = {}
    for name, dist in prog.items():
        s = dist.sample(scope, keygen(), reparam, active_platedims, K_dim,
                        dim_sizes)
        scope[name] = s
        result[name] = s
    return result


# ---- family table: one user-facing constructor per family ----------------

_dist_calls: dict[str, type] = {
    name: type(name, (_DistCall,), {"family": fam})
    for name, fam in FAMILIES.items()}
Normal = _dist_calls["Normal"]
Bernoulli = _dist_calls["Bernoulli"]
