"""Grouped latents sharing one K-dim (counterpart of ``alan_tpu/ir/group.py``).

Grouping variables makes them share a single K-dimension, cutting the
polynomial order of the K contraction (e.g. K^3 -> K^2 for a pair of parents
feeding one child).
"""
from .dist import _DistCall


class Group:
    def __init__(self, **kwargs):
        for varname, dist in kwargs.items():
            if not isinstance(dist, _DistCall):
                raise Exception(
                    f"{varname} in a Group should be a distribution, but is "
                    f"{type(dist)} (Timeseries are not ported yet)")
        if len(kwargs) < 2:
            raise Exception(
                f"Groups only make sense with two or more random variables; got {len(kwargs)}")
        self.prog = {varname: dist.finalize(varname)
                     for varname, dist in kwargs.items()}
