"""Distribution families in plain torch (counterpart of
``alan_tpu/distributions/families.py``).  This slice carries the two
families the MovieLens model uses, Normal and Bernoulli.

Every family declares:
  - ``args``: ordered parameter signature (name -> default), so positional
    binding matches ``alan_tpu``;
  - ``arg_event_ndim``: event rank of each parameter;
  - ``event_ndim``: event rank of a sample;
  - ``support``: a token that P/Q support checking compares;
  - ``sample(generator, shape, params)``: a draw of the full given shape on
    the generator's device;
  - ``log_prob(x, params)``: log-density with event dims reduced.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tnf

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


class Family:
    name: str = ""
    args: tuple = ()
    arg_event_ndim: dict = {}
    event_ndim: int = 0
    has_rsample: bool = True
    discrete: bool = False
    support: str = "real"

    @classmethod
    def bind_args(cls, args, kwargs):
        """Map positional/keyword user args onto parameter names."""
        names = [a for a, _ in cls.args]
        if len(args) > len(names):
            raise TypeError(f"{cls.name}: too many positional args")
        bound = dict(zip(names, args))
        for k, v in kwargs.items():
            if k not in names:
                raise TypeError(f"{cls.name}: unexpected arg {k}")
            if k in bound:
                raise TypeError(f"{cls.name}: duplicate arg {k}")
            bound[k] = v
        return bound

    @classmethod
    def canonicalize(cls, params: dict) -> dict:
        return params

    @classmethod
    def event_shape(cls, params) -> tuple | None:
        return None

    @classmethod
    def sample(cls, generator, shape, params):
        raise NotImplementedError(cls.name)

    @classmethod
    def log_prob(cls, x, params):
        raise NotImplementedError(cls.name)


class Normal(Family):
    name = "Normal"
    args = (("loc", None), ("scale", None))
    arg_event_ndim = {"loc": 0, "scale": 0}
    support = "real"

    @classmethod
    def sample(cls, generator, shape, p):
        eps = torch.randn(shape, generator=generator, device=generator.device)
        return p["loc"] + p["scale"] * eps

    @classmethod
    def log_prob(cls, x, p):
        z = (x - p["loc"]) / p["scale"]
        return -0.5 * z * z - torch.log(p["scale"]) - _HALF_LOG_2PI


def _probs_logits(p):
    """(probs, logits) from a param dict with exactly one of them."""
    probs = p.get("probs")
    logits = p.get("logits")
    if (probs is None) == (logits is None):
        raise ValueError("provide exactly one of probs/logits")
    if probs is None:
        probs = torch.sigmoid(logits)
    else:
        logits = torch.log(probs) - torch.log1p(-probs)
    return probs, logits


class Bernoulli(Family):
    name = "Bernoulli"
    args = (("probs", None), ("logits", None))
    arg_event_ndim = {"probs": 0, "logits": 0}
    support = "boolean"
    discrete = True
    has_rsample = False

    @classmethod
    def sample(cls, generator, shape, p):
        probs, _ = _probs_logits(p)
        u = torch.rand(shape, generator=generator, device=generator.device)
        return (u < probs).to(torch.float32)

    @classmethod
    def log_prob(cls, x, p):
        _, logits = _probs_logits(p)
        return x * logits - tnf.softplus(logits)


FAMILIES = {f.name: f for f in [Normal, Bernoulli]}
