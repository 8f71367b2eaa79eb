"""Exponential-family conversions between mean (moment) parameters and
conventional parameters, used by the QEM update (counterpart of
``alan_tpu/conversions.py``; this slice ports the Normal)."""
from __future__ import annotations

import torch

from .dims import as_dt, elementwise as ew
from .moments import mean, mean2
from .distributions import families as F


class NormalConversion:
    family = F.Normal
    sufficient_stats = (mean, mean2)

    @staticmethod
    def conv2mean(loc, scale):
        loc, scale = as_dt(loc), as_dt(scale)
        return loc, loc * loc + scale * scale

    @staticmethod
    def mean2conv(mean, mean2):
        mean, mean2 = as_dt(mean), as_dt(mean2)
        tiny = torch.finfo(torch.float32).tiny
        scale = ew(lambda m, m2: torch.sqrt(torch.clamp(m2 - m * m, min=tiny)),
                   mean, mean2)
        return {"loc": mean, "scale": scale}


conversion_dict = {
    F.Normal: NormalConversion,
}
