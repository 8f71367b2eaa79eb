"""Moment algebra (counterpart of ``alan_tpu/moments.py``).

``RawMoment(f)`` is a moment computable as E[f(x)]: ``Sample.moments``
reads it off the gradient of the ELBO with respect to a zero source term,
``from_samples`` averages it over N importance samples and
``from_marginals`` sums it against the marginal posterior weights over the
K-dims.  ``CompoundMoment`` combines raw moments (the variance is
E[x^2] - E[x]^2).
"""
from __future__ import annotations

import torch

from .dims import as_dt, dims_of, elementwise as ew, mean_dims, sum_dims


class Moment:
    pass


class RawMoment(Moment):
    def __init__(self, f, name=None):
        self.f = f
        self.name = name

    def from_samples(self, samples: tuple, Ndim: str):
        return mean_dims(self.f(*[as_dt(s) for s in samples]), (Ndim,))

    def from_marginals(self, samples: tuple, weights, all_platedims: dict):
        weights = as_dt(weights)
        f = as_dt(self.f(*[as_dt(s) for s in samples]))
        platenames = set(all_platedims)
        f_Kdims = set(dims_of(f)).difference(platenames)
        w_Kdims = set(dims_of(weights)).difference(platenames)
        assert f_Kdims.issubset(w_Kdims)
        assert len(w_Kdims) > 0
        return sum_dims(f * weights, tuple(w_Kdims))

    def all_raw_moments(self):
        return [self.f]


class CompoundMoment(Moment):
    def __init__(self, combiner, raw_moments):
        self.combiner = combiner
        for rm in raw_moments:
            assert isinstance(rm, RawMoment)
        self.raw_moments = raw_moments

    def from_samples(self, samples, Ndim):
        return self.combiner(*[rm.from_samples(samples, Ndim) for rm in self.raw_moments])

    def from_marginals(self, samples, weights, all_platedims):
        return self.combiner(*[rm.from_marginals(samples, weights, all_platedims)
                               for rm in self.raw_moments])

    def all_raw_moments(self):
        return self.raw_moments


#: the smallest normal float32, the floor of a variance or a deviation
_TINY = torch.finfo(torch.float32).tiny


def var_from_raw_moment(rm: RawMoment):
    """E[f^2] - E[f]^2, clamped to the smallest normal float."""
    assert isinstance(rm, RawMoment)
    rm2 = RawMoment(lambda x: rm.f(x) ** 2)

    def combiner(Ex, Ex2):
        return ew(lambda a, b: torch.clamp(b - a * a, min=_TINY), Ex, Ex2)

    return CompoundMoment(combiner, [rm, rm2])


def std_from_raw_moment(rm: RawMoment):
    assert isinstance(rm, RawMoment)
    rm2 = RawMoment(lambda x: rm.f(x) ** 2)

    def combiner(Ex, Ex2):
        return ew(lambda a, b: torch.clamp(torch.sqrt(b - a * a), min=_TINY),
                  Ex, Ex2)

    return CompoundMoment(combiner, [rm, rm2])


mean = RawMoment(lambda x: as_dt(x), name="mean")
mean2 = RawMoment(lambda x: as_dt(x) ** 2, name="mean2")
mean_log = RawMoment(lambda x: as_dt(x).log(), name="mean_log")
mean_log1m = RawMoment(lambda x: ew(lambda v: torch.log(1.0 - v), x), name="mean_log1m")
mean_recip = RawMoment(lambda x: 1.0 / as_dt(x), name="mean_recip")
var = var_from_raw_moment(mean)


def vec_square(x):
    return ew(lambda v: v[..., :, None] @ v[..., None, :], x)


mean_xxT = RawMoment(vec_square, name="mean_xxT")
cov_x = CompoundMoment(lambda Ex, ExxT: ExxT - vec_square(Ex), [mean, mean_xxT])

moments_func2name = {
    mean: "mean",
    mean2: "mean2",
    mean_log: "mean_log",
    mean_log1m: "mean_log1m",
    mean_recip: "mean_recip",
    mean_xxT: "mean_xxT",
}


def uniformise_moment_args(args):
    """Accept ``('a', mean)``, ``(('a', 'b'), cov)`` or a list of such
    pairs."""
    assert isinstance(args, tuple)
    err = Exception(
        ".moments must be called as .moments(varname, moment) or "
        ".moments([(varname, moment), ...])")
    if len(args) == 1:
        args = args[0]
        if not isinstance(args, (list, tuple)):
            raise err
    elif len(args) == 2:
        args = [(args[0], args[1])]
    else:
        raise err

    result = []
    for k, v in args:
        if not isinstance(k, (tuple, str)):
            raise err
        if not isinstance(v, Moment):
            raise err
        if not isinstance(k, tuple):
            k = (k,)
        result.append((k, v))
    return result


def postproc_moment_outputs(result, raw_moms):
    """One moment asked for as ``(varname, moment)`` comes back alone."""
    if len(raw_moms) == 2:
        assert len(result) == 1
        result = result[0]
    return result


def dt_moments_mixin(self, *args, **kwargs):
    moms = uniformise_moment_args(args)
    result = self._moments_uniform_input(moms, **kwargs)
    return postproc_moment_outputs(result, args)
