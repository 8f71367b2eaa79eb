"""Moment algebra (counterpart of ``alan_tpu/moments.py``; this slice
ports the raw moments the Normal QEM update needs).

``RawMoment(f)`` is a moment computable as E[f(x)]; ``Sample.moments`` reads
it off the gradient of the ELBO with respect to a zero source term.
"""
from __future__ import annotations

from .dims import as_dt


class Moment:
    pass


class RawMoment(Moment):
    def __init__(self, f, name=None):
        self.f = f
        self.name = name


mean = RawMoment(lambda x: as_dt(x), name="mean")
mean2 = RawMoment(lambda x: as_dt(x) ** 2, name="mean2")

moments_func2name = {
    mean: "mean",
    mean2: "mean2",
}


def uniformise_moment_args(args):
    """Accept ``('a', mean)`` or a list of ``(varname(s), moment)`` pairs."""
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


def dt_moments_mixin(self, *args, **kwargs):
    moms = uniformise_moment_args(args)
    result = self._moments_uniform_input(moms, **kwargs)
    if len(args) == 2:
        assert len(result) == 1
        result = result[0]
    return result
