"""Distribution families in plain torch (counterpart of
``alan_tpu/distributions/families.py``).  The port carries the families
its models use: Normal and Bernoulli (MovieLens), NegativeBinomial (covid),
and Beta (the Beta-Bernoulli oracle of the global-K baseline).

Every family declares:
  - ``args``: ordered parameter signature (name -> default), so positional
    binding matches ``alan_tpu``;
  - ``arg_event_ndim``: event rank of each parameter;
  - ``event_ndim``: event rank of a sample;
  - ``support``: a token that P/Q support checking compares;
  - ``sample(generator, shape, params)``: a draw of the full given shape on
    the generator's device;
  - ``from_noise(eps, params)`` (families with a reparameterised draw): the
    draw that the standard noise ``eps`` gives, differentiable in the
    parameters;
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
    def from_noise(cls, eps, params):
        raise NotImplementedError(f"{cls.name} has no reparameterised draw")

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
        return cls.from_noise(eps, p)

    @classmethod
    def from_noise(cls, eps, p):
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


class NegativeBinomial(Family):
    """Counts of successes before ``total_count`` failures, success
    probability ``probs``: pmf(x) proportional to (1 - p)^r p^x (torch's
    convention, as ``alan_tpu``)."""
    name = "NegativeBinomial"
    args = (("total_count", None), ("probs", None), ("logits", None))
    arg_event_ndim = {"total_count": 0, "probs": 0, "logits": 0}
    support = "nonneg_int"
    discrete = True
    has_rsample = False

    @classmethod
    def sample(cls, generator, shape, p):
        # Gamma-Poisson mixture: lambda ~ Gamma(r, 1) * p / (1 - p)
        probs, _ = _probs_logits(p)
        probs = torch.broadcast_to(probs, shape)
        r = torch.broadcast_to(torch.as_tensor(p["total_count"], dtype=torch.float32,
                                               device=generator.device), shape)
        lam = torch._standard_gamma(r.contiguous(), generator=generator) \
            * (probs / (1.0 - probs))
        return torch.poisson(lam, generator=generator)

    @classmethod
    def log_prob(cls, x, p):
        probs, _ = _probs_logits(p)
        r = p["total_count"]
        return (torch.lgamma(x + r) - torch.lgamma(r) - torch.lgamma(x + 1.0)
                + torch.xlogy(r, 1.0 - probs) + torch.xlogy(x, probs))


class Beta(Family):
    name = "Beta"
    args = (("concentration1", None), ("concentration0", None))
    arg_event_ndim = {"concentration1": 0, "concentration0": 0}
    support = "unit_interval"

    @classmethod
    def sample(cls, generator, shape, p):
        # X / (X + Y) of two unit-rate gammas; ``_standard_gamma`` is
        # differentiable in its concentration (implicit reparameterisation),
        # so the draw is reparameterised without a standard noise of its own
        a, b = (torch.broadcast_to(torch.as_tensor(p[k], dtype=torch.float32,
                                                   device=generator.device), shape)
                .contiguous() for k in ("concentration1", "concentration0"))
        x = torch._standard_gamma(a, generator=generator)
        y = torch._standard_gamma(b, generator=generator)
        eps = torch.finfo(torch.float32).eps
        return torch.clamp(x / (x + y), min=torch.finfo(torch.float32).tiny, max=1.0 - eps)

    @classmethod
    def log_prob(cls, x, p):
        a, b = p["concentration1"], p["concentration0"]
        return (torch.xlogy(a - 1.0, x) + torch.xlogy(b - 1.0, 1.0 - x)
                - (torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)))


FAMILIES = {f.name: f for f in [Normal, Bernoulli, NegativeBinomial, Beta]}
