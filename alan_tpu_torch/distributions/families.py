"""Distribution families in plain torch (counterpart of
``alan_tpu/distributions/families.py``): the same 35 families, with the
same metadata, so that P/Q support checking and VI's reparameterisation
decide alike in both packages.

Every family declares:
  - ``args``: ordered parameter signature (name -> default), so positional
    binding matches ``alan_tpu``;
  - ``arg_event_ndim``: event rank of each parameter;
  - ``event_ndim``: event rank of a sample;
  - ``support``: a token that P/Q support checking compares;
  - ``sample(generator, shape, params)``: a draw of the full given shape
    (event axes included) on the generator's device;
  - ``log_prob(x, params)``: log-density with event dims reduced.

A family with a reparameterised draw (``has_rsample``) splits it in two:
``noise(generator, shape, params)`` draws its standard noise, detached,
and ``from_noise(eps, params)`` makes the draw of that noise,
differentiable in the parameters; ``sample`` is the one after the other,
so a generator's draw and an injected noise give one draw.  The noise of
each family:

  - a transform of a standard variate: that variate.  Normal, LogNormal,
    HalfNormal, MultivariateNormal and LowRankMultivariateNormal take a
    standard normal; Cauchy and HalfCauchy a standard Cauchy; Laplace a
    standard Laplace; Gumbel and RelaxedOneHotCategorical a standard
    Gumbel; Exponential a standard exponential; Uniform, Kumaraswamy,
    Pareto, Weibull, ContinuousBernoulli, LogitRelaxedBernoulli and
    RelaxedBernoulli a uniform on (tiny, 1).
  - Gamma and Chi2: the standard gamma draw g at the concentration a,
    with the implicit gradient dg/da = -(dF/da)/f(g) of
    ``torch._standard_gamma`` (what ``jax.random.gamma`` differentiates
    by), divided by the rate.
  - Beta and Dirichlet: the draw itself, with the implicit gradient of
    ``torch._dirichlet_grad``.  ``alan_tpu``'s Beta differentiates through
    its ratio of two gammas instead: another pathwise estimator of the
    same gradient, equal in expectation.
  - StudentT and FisherSnedecor: two numbers per draw, stacked on a last
    axis of 2 (``noise_event``): StudentT a standard normal and a standard
    gamma at df/2, FisherSnedecor standard gammas at df1/2 and df2/2, each
    gamma with its implicit gradient.
  - Wishart: a matrix of the draw's shape, standard normals below the
    diagonal of Bartlett's factor and on the diagonal the standard gammas
    at (df - i)/2 whose doubled square roots it holds.
  - LKJCholesky: a matrix of the draw's shape, each row's standard normals
    (the onion method's direction) below the diagonal and on the diagonal
    the row's Beta(i/2, concentration + (d - 1 - i)/2) draw, with the
    implicit gradient.

VonMises and the discrete families draw directly (``has_rsample`` False).
VonMises runs a fixed 32 rounds of Best-Fisher rejection, as ``alan_tpu``:
no loop that stops on the data, which would read the card from the host.

Cholesky factors come from ``torch.linalg.cholesky_ex`` without its host
check, so a factorisation never synchronises with the card (a CUDA graph
captures it).  A matrix that is not positive definite gives NaN in the
lower triangle, as ``jnp.linalg.cholesky`` does; it raises nothing.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tnf

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_TINY = torch.finfo(torch.float32).tiny
_EPS = torch.finfo(torch.float32).eps


class Family:
    name: str = ""
    args: tuple = ()
    arg_event_ndim: dict = {}
    event_ndim: int = 0
    has_rsample: bool = True
    discrete: bool = False
    support: str = "real"
    #: trailing axes the standard noise has beyond the draw's shape
    noise_event: tuple = ()

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
        return cls.from_noise(cls.noise(generator, shape, params), params)

    @classmethod
    def noise(cls, generator, shape, params):
        raise NotImplementedError(f"{cls.name} has no reparameterised draw")

    @classmethod
    def from_noise(cls, eps, params):
        raise NotImplementedError(f"{cls.name} has no reparameterised draw")

    @classmethod
    def log_prob(cls, x, params):
        raise NotImplementedError(cls.name)


# ---- standard variates and implicit gradients ----------------------------------

def _normal(g, shape):
    return torch.randn(shape, generator=g, device=g.device)


def _uniform(g, shape):
    """Uniform on [tiny, 1), as ``alan_tpu``'s ``_u``."""
    return torch.rand(shape, generator=g, device=g.device).clamp_(min=_TINY)


def _cauchy(g, shape):
    return torch.tan(math.pi * (_uniform(g, shape) - 0.5))


def _gumbel(g, shape):
    return -torch.log(-torch.log(_uniform(g, shape)))


def _tensor(a, device):
    """``a`` as a tensor; a number becomes a float32 fill on ``device``, not
    a copy from the host (which a CUDA graph's capture refuses)."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.full((), float(a), device=device)


def _broadcast(a, shape, device):
    """``a`` detached, as a contiguous float32 tensor of ``shape``."""
    return torch.broadcast_to(_tensor(a, device).detach().to(torch.float32),
                              shape).contiguous()


def _standard_gamma(g, conc, shape):
    return torch._standard_gamma(_broadcast(conc, shape, g.device), generator=g)


class _ImplicitGamma(torch.autograd.Function):
    """A standard gamma draw ``g`` at concentration ``a``, passed through,
    with the implicit gradient of ``torch._standard_gamma``."""

    @staticmethod
    def forward(ctx, g, a):
        ctx.save_for_backward(g, a)
        return g.clone()

    @staticmethod
    def backward(ctx, grad):
        g, a = ctx.saved_tensors
        da = torch._standard_gamma_grad(a.expand(g.shape).contiguous(), g)
        return grad, (grad * da).sum_to_size(a.shape)


class _ImplicitDirichlet(torch.autograd.Function):
    """A Dirichlet draw ``x`` at concentration ``alpha``, passed through,
    with the implicit gradient of ``torch._dirichlet_grad`` (as
    ``torch.distributions.Dirichlet.rsample``)."""

    @staticmethod
    def forward(ctx, x, alpha):
        ctx.save_for_backward(x, alpha)
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        x, alpha = ctx.saved_tensors
        a = alpha.expand(x.shape).contiguous()
        total = a.sum(-1, keepdim=True).expand_as(a).contiguous()
        dx = torch._dirichlet_grad(x.contiguous(), a, total)
        da = dx * (grad - (x * grad).sum(-1, keepdim=True))
        return grad, da.sum_to_size(alpha.shape)


def _implicit_gamma(g, a):
    if not (isinstance(a, torch.Tensor) and a.requires_grad):
        return g
    return _ImplicitGamma.apply(g, a)


def _implicit_dirichlet(x, alpha):
    if not alpha.requires_grad:
        return x
    return _ImplicitDirichlet.apply(x, alpha)


def _implicit_beta(x, a, b):
    """A Beta(a, b) draw ``x`` with the implicit gradient in a and b."""
    alpha = torch.stack(torch.broadcast_tensors(_tensor(a, x.device),
                                                _tensor(b, x.device)), -1)
    if not alpha.requires_grad:
        return x
    shape = torch.broadcast_shapes(x.shape, alpha.shape[:-1])
    xx = torch.stack([x.expand(shape), 1.0 - x.expand(shape)], -1)
    return _ImplicitDirichlet.apply(xx, alpha)[..., 0]


def _beta_draw(g, a, b, shape):
    """A Beta(a, b) draw of ``shape`` as a ratio of two unit-rate gammas,
    detached, clamped inside (0, 1)."""
    x = _standard_gamma(g, a, shape)
    y = _standard_gamma(g, b, shape)
    return torch.clamp(x / (x + y), min=_TINY, max=1.0 - _EPS)


def _cholesky(m):
    """Lower Cholesky factor without a host check; NaN in the lower
    triangle where ``m`` is not positive definite."""
    L, info = torch.linalg.cholesky_ex(m, check_errors=False)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")).tril(), L)


# ---- continuous univariate -------------------------------------------------------

class Normal(Family):
    name = "Normal"
    args = (("loc", None), ("scale", None))
    arg_event_ndim = {"loc": 0, "scale": 0}
    support = "real"

    @classmethod
    def noise(cls, g, shape, p):
        return _normal(g, shape)

    @classmethod
    def from_noise(cls, eps, p):
        return p["loc"] + p["scale"] * eps

    @classmethod
    def log_prob(cls, x, p):
        z = (x - p["loc"]) / p["scale"]
        return -0.5 * z * z - torch.log(p["scale"]) - _HALF_LOG_2PI


class HalfNormal(Family):
    name = "HalfNormal"
    args = (("scale", None),)
    arg_event_ndim = {"scale": 0}
    support = "positive"

    @classmethod
    def noise(cls, g, shape, p):
        return _normal(g, shape)

    @classmethod
    def from_noise(cls, eps, p):
        return torch.abs(p["scale"] * eps)

    @classmethod
    def log_prob(cls, x, p):
        z = x / p["scale"]
        lp = -0.5 * z * z - torch.log(p["scale"]) - _HALF_LOG_2PI + math.log(2.0)
        return torch.where(x >= 0, lp, -math.inf)


class Cauchy(Family):
    name = "Cauchy"
    args = (("loc", None), ("scale", None))
    arg_event_ndim = {"loc": 0, "scale": 0}
    support = "real"

    @classmethod
    def noise(cls, g, shape, p):
        return _cauchy(g, shape)

    @classmethod
    def from_noise(cls, eps, p):
        return p["loc"] + p["scale"] * eps

    @classmethod
    def log_prob(cls, x, p):
        z = (x - p["loc"]) / p["scale"]
        return -torch.log1p(z * z) - torch.log(p["scale"]) - math.log(math.pi)


class HalfCauchy(Family):
    name = "HalfCauchy"
    args = (("scale", None),)
    arg_event_ndim = {"scale": 0}
    support = "positive"

    @classmethod
    def noise(cls, g, shape, p):
        return _cauchy(g, shape)

    @classmethod
    def from_noise(cls, eps, p):
        return torch.abs(p["scale"] * eps)

    @classmethod
    def log_prob(cls, x, p):
        z = x / p["scale"]
        lp = -torch.log1p(z * z) - torch.log(p["scale"]) + math.log(2.0 / math.pi)
        return torch.where(x >= 0, lp, -math.inf)


class LogNormal(Family):
    name = "LogNormal"
    args = (("loc", None), ("scale", None))
    arg_event_ndim = {"loc": 0, "scale": 0}
    support = "positive"

    @classmethod
    def noise(cls, g, shape, p):
        return _normal(g, shape)

    @classmethod
    def from_noise(cls, eps, p):
        return torch.exp(p["loc"] + p["scale"] * eps)

    @classmethod
    def log_prob(cls, x, p):
        lx = torch.log(x)
        z = (lx - p["loc"]) / p["scale"]
        return -0.5 * z * z - torch.log(p["scale"]) - _HALF_LOG_2PI - lx


class Uniform(Family):
    name = "Uniform"
    args = (("low", None), ("high", None))
    arg_event_ndim = {"low": 0, "high": 0}
    support = "interval"

    @classmethod
    def noise(cls, g, shape, p):
        return _uniform(g, shape)

    @classmethod
    def from_noise(cls, eps, p):
        return p["low"] + (p["high"] - p["low"]) * eps

    @classmethod
    def log_prob(cls, x, p):
        inside = (x >= p["low"]) & (x <= p["high"])
        return torch.where(inside, -torch.log(p["high"] - p["low"]), -math.inf)


class Exponential(Family):
    name = "Exponential"
    args = (("rate", None),)
    arg_event_ndim = {"rate": 0}
    support = "positive"

    @classmethod
    def noise(cls, g, shape, p):
        return -torch.log(_uniform(g, shape))

    @classmethod
    def from_noise(cls, eps, p):
        return eps / p["rate"]

    @classmethod
    def log_prob(cls, x, p):
        return torch.log(p["rate"]) - p["rate"] * x


class Gamma(Family):
    name = "Gamma"
    args = (("concentration", None), ("rate", None))
    arg_event_ndim = {"concentration": 0, "rate": 0}
    support = "positive"

    @classmethod
    def noise(cls, g, shape, p):
        return _standard_gamma(g, p["concentration"], shape)

    @classmethod
    def from_noise(cls, eps, p):
        return _implicit_gamma(eps, p["concentration"]) / p["rate"]

    @classmethod
    def log_prob(cls, x, p):
        a, b = p["concentration"], p["rate"]
        return torch.xlogy(a, b) + torch.xlogy(a - 1.0, x) - b * x - torch.lgamma(a)


class Chi2(Gamma):
    name = "Chi2"
    args = (("df", None),)
    arg_event_ndim = {"df": 0}
    support = "positive"

    @classmethod
    def canonicalize(cls, p):
        if "df" in p:
            return {"concentration": p["df"] / 2.0, "rate": 0.5}
        return p


class Beta(Family):
    name = "Beta"
    args = (("concentration1", None), ("concentration0", None))
    arg_event_ndim = {"concentration1": 0, "concentration0": 0}
    support = "unit_interval"

    @classmethod
    def noise(cls, g, shape, p):
        return _beta_draw(g, p["concentration1"], p["concentration0"], shape)

    @classmethod
    def from_noise(cls, eps, p):
        return _implicit_beta(eps, p["concentration1"], p["concentration0"])

    @classmethod
    def log_prob(cls, x, p):
        a, b = p["concentration1"], p["concentration0"]
        return (torch.xlogy(a - 1.0, x) + torch.xlogy(b - 1.0, 1.0 - x)
                - (torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)))


class StudentT(Family):
    name = "StudentT"
    args = (("df", None), ("loc", 0.0), ("scale", 1.0))
    arg_event_ndim = {"df": 0, "loc": 0, "scale": 0}
    support = "real"
    noise_event = (2,)

    @classmethod
    def noise(cls, g, shape, p):
        return torch.stack([_normal(g, shape),
                            _standard_gamma(g, p["df"] / 2.0, shape)], -1)

    @classmethod
    def from_noise(cls, eps, p):
        half_df = p["df"] / 2.0
        gam = _implicit_gamma(eps[..., 1], half_df)
        return p["loc"] + p["scale"] * (eps[..., 0] * torch.sqrt(half_df / gam))

    @classmethod
    def log_prob(cls, x, p):
        df, loc, scale = p["df"], p["loc"], p["scale"]
        z = (x - loc) / scale
        return (torch.lgamma((df + 1.0) / 2.0) - torch.lgamma(df / 2.0)
                - 0.5 * torch.log(df * math.pi) - torch.log(scale)
                - 0.5 * (df + 1.0) * torch.log1p(z * z / df))


class Laplace(Family):
    name = "Laplace"
    args = (("loc", None), ("scale", None))
    arg_event_ndim = {"loc": 0, "scale": 0}
    support = "real"

    @classmethod
    def noise(cls, g, shape, p):
        u = torch.rand(shape, generator=g, device=g.device) * 2.0 - 1.0
        u = u.clamp_(min=-1.0 + _EPS)
        return torch.sign(u) * torch.log1p(-torch.abs(u))

    @classmethod
    def from_noise(cls, eps, p):
        return p["loc"] + p["scale"] * eps

    @classmethod
    def log_prob(cls, x, p):
        return -torch.abs(x - p["loc"]) / p["scale"] - torch.log(2.0 * p["scale"])


class Gumbel(Family):
    name = "Gumbel"
    args = (("loc", None), ("scale", None))
    arg_event_ndim = {"loc": 0, "scale": 0}
    support = "real"

    @classmethod
    def noise(cls, g, shape, p):
        return _gumbel(g, shape)

    @classmethod
    def from_noise(cls, eps, p):
        return p["loc"] + p["scale"] * eps

    @classmethod
    def log_prob(cls, x, p):
        z = (x - p["loc"]) / p["scale"]
        return -(z + torch.exp(-z)) - torch.log(p["scale"])


class Kumaraswamy(Family):
    name = "Kumaraswamy"
    args = (("concentration1", None), ("concentration0", None))
    arg_event_ndim = {"concentration1": 0, "concentration0": 0}
    support = "unit_interval"

    @classmethod
    def noise(cls, g, shape, p):
        return _uniform(g, shape)

    @classmethod
    def from_noise(cls, eps, p):
        a, b = p["concentration1"], p["concentration0"]
        return (1.0 - eps ** (1.0 / b)) ** (1.0 / a)

    @classmethod
    def log_prob(cls, x, p):
        a, b = p["concentration1"], p["concentration0"]
        return (torch.log(a) + torch.log(b) + torch.xlogy(a - 1.0, x)
                + torch.xlogy(b - 1.0, 1.0 - x ** a))


class Pareto(Family):
    name = "Pareto"
    args = (("scale", None), ("alpha", None))
    arg_event_ndim = {"scale": 0, "alpha": 0}
    support = "positive"

    @classmethod
    def noise(cls, g, shape, p):
        return _uniform(g, shape)

    @classmethod
    def from_noise(cls, eps, p):
        return p["scale"] * eps ** (-1.0 / p["alpha"])

    @classmethod
    def log_prob(cls, x, p):
        s, a = p["scale"], p["alpha"]
        lp = torch.log(a) + a * torch.log(s) - (a + 1.0) * torch.log(x)
        return torch.where(x >= s, lp, -math.inf)


class Weibull(Family):
    name = "Weibull"
    args = (("scale", None), ("concentration", None))
    arg_event_ndim = {"scale": 0, "concentration": 0}
    support = "positive"

    @classmethod
    def noise(cls, g, shape, p):
        return _uniform(g, shape)

    @classmethod
    def from_noise(cls, eps, p):
        return p["scale"] * (-torch.log(eps)) ** (1.0 / p["concentration"])

    @classmethod
    def log_prob(cls, x, p):
        s, k = p["scale"], p["concentration"]
        z = x / s
        return torch.log(k / s) + torch.xlogy(k - 1.0, z) - z ** k


class FisherSnedecor(Family):
    name = "FisherSnedecor"
    args = (("df1", None), ("df2", None))
    arg_event_ndim = {"df1": 0, "df2": 0}
    support = "positive"
    noise_event = (2,)

    @classmethod
    def noise(cls, g, shape, p):
        return torch.stack([_standard_gamma(g, p["df1"] / 2.0, shape),
                            _standard_gamma(g, p["df2"] / 2.0, shape)], -1)

    @classmethod
    def from_noise(cls, eps, p):
        d1, d2 = p["df1"], p["df2"]
        x1 = 2.0 * _implicit_gamma(eps[..., 0], d1 / 2.0)
        x2 = 2.0 * _implicit_gamma(eps[..., 1], d2 / 2.0)
        return (x1 / d1) / (x2 / d2)

    @classmethod
    def log_prob(cls, x, p):
        d1, d2 = p["df1"], p["df2"]
        return (0.5 * d1 * torch.log(d1) + 0.5 * d2 * torch.log(d2)
                + (0.5 * d1 - 1.0) * torch.log(x)
                - 0.5 * (d1 + d2) * torch.log(d2 + d1 * x)
                - (torch.lgamma(d1 / 2.0) + torch.lgamma(d2 / 2.0)
                   - torch.lgamma((d1 + d2) / 2.0)))


class VonMises(Family):
    name = "VonMises"
    args = (("loc", None), ("concentration", None))
    arg_event_ndim = {"loc": 0, "concentration": 0}
    support = "circular"
    has_rsample = False

    #: rounds of Best-Fisher rejection, fixed as in ``alan_tpu``
    ROUNDS = 32

    @classmethod
    def sample(cls, g, shape, p):
        kappa = _broadcast(p["concentration"], shape, g.device)
        tau = 1.0 + torch.sqrt(1.0 + 4.0 * kappa ** 2)
        rho = (tau - torch.sqrt(2.0 * tau)) / (2.0 * kappa)
        r = (1.0 + rho ** 2) / (2.0 * rho)
        accepted = torch.zeros(shape, dtype=torch.bool, device=g.device)
        val = torch.zeros(shape, device=g.device)
        for _ in range(cls.ROUNDS):
            u1, u2, u3 = torch.rand((3, *shape), generator=g, device=g.device)
            z = torch.cos(math.pi * u1)
            f = (1.0 + r * z) / (r + z)
            c = kappa * (r - f)
            accept = (c * (2.0 - c) - u2 > 0) | (torch.log(c / u2) + 1.0 - c >= 0)
            new_val = torch.sign(u3 - 0.5) * torch.arccos(torch.clamp(f, -1.0, 1.0))
            val = torch.where(accepted, val, torch.where(accept, new_val, val))
            accepted = accepted | accept
        out = val + p["loc"]
        return torch.atan2(torch.sin(out), torch.cos(out))

    @classmethod
    def log_prob(cls, x, p):
        kappa = p["concentration"]
        return (kappa * torch.cos(x - p["loc"]) - math.log(2.0 * math.pi)
                - torch.log(torch.special.i0e(kappa)) - kappa)


# ---- discrete -------------------------------------------------------------------

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
    def sample(cls, g, shape, p):
        probs, _ = _probs_logits(p)
        u = torch.rand(shape, generator=g, device=g.device)
        return (u < probs).to(torch.float32)

    @classmethod
    def log_prob(cls, x, p):
        _, logits = _probs_logits(p)
        return x * logits - tnf.softplus(logits)


class ContinuousBernoulli(Family):
    name = "ContinuousBernoulli"
    args = (("probs", None), ("logits", None))
    arg_event_ndim = {"probs": 0, "logits": 0}
    support = "unit_interval"

    @classmethod
    def _log_norm(cls, probs):
        # log C(p); C(p) = 2 atanh(1 - 2p) / (1 - 2p) for p != .5, -> 2 at .5
        near_half = torch.abs(probs - 0.5) < 1e-4
        safe = torch.where(near_half, 0.4, probs)
        c = 2.0 * torch.atanh(1.0 - 2.0 * safe) / (1.0 - 2.0 * safe)
        taylor = 2.0 + (4.0 / 3.0) * (probs - 0.5) ** 2
        return torch.log(torch.where(near_half, taylor, c))

    @classmethod
    def noise(cls, g, shape, p):
        return _uniform(g, shape)

    @classmethod
    def from_noise(cls, eps, p):
        probs, _ = _probs_logits(p)
        near_half = torch.abs(probs - 0.5) < 1e-4
        safe = torch.where(near_half, 0.4, probs)
        # the inverse CDF
        x = (torch.log1p(eps * (2.0 * safe - 1.0) / (1.0 - safe))
             / (torch.log(safe) - torch.log1p(-safe)))
        return torch.where(near_half, eps, x)

    @classmethod
    def log_prob(cls, x, p):
        probs, logits = _probs_logits(p)
        return x * logits + torch.log1p(-probs) + cls._log_norm(probs)


class Binomial(Family):
    name = "Binomial"
    args = (("total_count", 1), ("probs", None), ("logits", None))
    arg_event_ndim = {"total_count": 0, "probs": 0, "logits": 0}
    support = "nonneg_int"
    discrete = True
    has_rsample = False

    @classmethod
    def sample(cls, g, shape, p):
        probs, _ = _probs_logits(p)
        return torch.binomial(_broadcast(p["total_count"], shape, g.device),
                              _broadcast(probs, shape, g.device), generator=g)

    @classmethod
    def log_prob(cls, x, p):
        _, logits = _probs_logits(p)
        n = _tensor(p["total_count"], x.device)
        log_comb = torch.lgamma(n + 1.0) - torch.lgamma(x + 1.0) - torch.lgamma(n - x + 1.0)
        return log_comb + x * logits - n * tnf.softplus(logits)


class Poisson(Family):
    name = "Poisson"
    args = (("rate", None),)
    arg_event_ndim = {"rate": 0}
    support = "nonneg_int"
    discrete = True
    has_rsample = False

    @classmethod
    def sample(cls, g, shape, p):
        return torch.poisson(_broadcast(p["rate"], shape, g.device), generator=g)

    @classmethod
    def log_prob(cls, x, p):
        lam = p["rate"]
        return torch.xlogy(x, lam) - lam - torch.lgamma(x + 1.0)


class Geometric(Family):
    name = "Geometric"
    args = (("probs", None), ("logits", None))
    arg_event_ndim = {"probs": 0, "logits": 0}
    support = "nonneg_int"
    discrete = True
    has_rsample = False

    @classmethod
    def sample(cls, g, shape, p):
        probs, _ = _probs_logits(p)
        u = _uniform(g, shape)
        return torch.floor(torch.log(u) / torch.log1p(-_broadcast(probs, shape, g.device)))

    @classmethod
    def log_prob(cls, x, p):
        probs, _ = _probs_logits(p)
        return torch.xlogy(x, 1.0 - probs) + torch.log(probs)


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
    def sample(cls, g, shape, p):
        # Gamma-Poisson mixture: lambda ~ Gamma(r, 1) * p / (1 - p)
        probs, _ = _probs_logits(p)
        probs = torch.broadcast_to(probs, shape)
        lam = _standard_gamma(g, p["total_count"], shape) * (probs / (1.0 - probs))
        return torch.poisson(lam, generator=g)

    @classmethod
    def log_prob(cls, x, p):
        probs, _ = _probs_logits(p)
        r = p["total_count"]
        return (torch.lgamma(x + r) - torch.lgamma(r) - torch.lgamma(x + 1.0)
                + torch.xlogy(r, 1.0 - probs) + torch.xlogy(x, probs))


def _cat_probs_logits(p):
    """(probs, logits) over the last axis, normalised, from exactly one."""
    probs = p.get("probs")
    logits = p.get("logits")
    if (probs is None) == (logits is None):
        raise ValueError("provide exactly one of probs/logits")
    if probs is None:
        logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
        probs = torch.exp(logits)
    else:
        probs = probs / torch.sum(probs, dim=-1, keepdim=True)
        logits = torch.log(probs)
    return probs, logits


def _categorical(g, logits, shape):
    """Indices of ``shape`` drawn from ``logits`` (last axis), by the
    Gumbel-max trick as ``jax.random.categorical``."""
    full = tuple(shape) + tuple(logits.shape[-1:])
    logits = torch.broadcast_to(logits.detach(), full)
    return torch.argmax(logits + _gumbel(g, full), dim=-1)


class Categorical(Family):
    name = "Categorical"
    args = (("probs", None), ("logits", None))
    arg_event_ndim = {"probs": 1, "logits": 1}
    event_ndim = 0
    support = "int"
    discrete = True
    has_rsample = False

    @classmethod
    def sample(cls, g, shape, p):
        _, logits = _cat_probs_logits(p)
        return _categorical(g, logits, shape).to(torch.float32)

    @classmethod
    def log_prob(cls, x, p):
        _, logits = _cat_probs_logits(p)
        xi = x.to(torch.int64)
        b = torch.broadcast_shapes(xi.shape, logits.shape[:-1])
        logits = torch.broadcast_to(logits, b + logits.shape[-1:])
        return torch.gather(logits, -1, torch.broadcast_to(xi, b)[..., None])[..., 0]


class OneHotCategorical(Family):
    name = "OneHotCategorical"
    args = (("probs", None), ("logits", None))
    arg_event_ndim = {"probs": 1, "logits": 1}
    event_ndim = 1
    support = "one_hot"
    discrete = True
    has_rsample = False

    @classmethod
    def sample(cls, g, shape, p):
        _, logits = _cat_probs_logits(p)
        idx = _categorical(g, logits, shape[:-1])
        return tnf.one_hot(idx, shape[-1]).to(torch.float32)

    @classmethod
    def log_prob(cls, x, p):
        _, logits = _cat_probs_logits(p)
        return torch.sum(x * logits, dim=-1)


class Multinomial(Family):
    name = "Multinomial"
    args = (("total_count", 1), ("probs", None), ("logits", None))
    arg_event_ndim = {"total_count": 0, "probs": 1, "logits": 1}
    event_ndim = 1
    support = "multinomial"
    discrete = True
    has_rsample = False

    @classmethod
    def sample(cls, g, shape, p):
        probs, _ = _cat_probs_logits(p)
        n, k = int(p["total_count"]), shape[-1]
        probs = _broadcast(probs, shape, g.device).reshape(-1, k)
        idx = torch.multinomial(probs, n, replacement=True, generator=g)
        counts = torch.zeros_like(probs).scatter_add_(
            1, idx, torch.ones(idx.shape, device=probs.device))
        return counts.reshape(shape)

    @classmethod
    def log_prob(cls, x, p):
        _, logits = _cat_probs_logits(p)
        n = torch.sum(x, dim=-1)
        return (torch.lgamma(n + 1.0) - torch.sum(torch.lgamma(x + 1.0), dim=-1)
                + torch.sum(x * logits, dim=-1))


# ---- multivariate continuous ---------------------------------------------------------

class Dirichlet(Family):
    name = "Dirichlet"
    args = (("concentration", None),)
    arg_event_ndim = {"concentration": 1}
    event_ndim = 1
    support = "simplex"

    @classmethod
    def noise(cls, g, shape, p):
        return torch._sample_dirichlet(_broadcast(p["concentration"], shape, g.device),
                                       generator=g)

    @classmethod
    def from_noise(cls, eps, p):
        return _implicit_dirichlet(eps, p["concentration"])

    @classmethod
    def log_prob(cls, x, p):
        a = p["concentration"]
        return (torch.sum(torch.xlogy(a - 1.0, x), dim=-1)
                + torch.lgamma(torch.sum(a, dim=-1))
                - torch.sum(torch.lgamma(a), dim=-1))


class MultivariateNormal(Family):
    name = "MultivariateNormal"
    args = (("loc", None), ("covariance_matrix", None), ("precision_matrix", None),
            ("scale_tril", None))
    arg_event_ndim = {"loc": 1, "covariance_matrix": 2, "precision_matrix": 2,
                      "scale_tril": 2}
    event_ndim = 1
    support = "real_vector"

    @classmethod
    def _chol(cls, p):
        """A lower-triangular L with L L^T the covariance."""
        if p.get("scale_tril") is not None:
            return p["scale_tril"]
        if p.get("covariance_matrix") is not None:
            return _cholesky(p["covariance_matrix"])
        if p.get("precision_matrix") is not None:
            # the covariance's own factor: alan_tpu takes the transposed
            # inverse of the precision's factor, which is upper triangular
            # (ROADMAP queue 3)
            prec = p["precision_matrix"]
            eye = torch.eye(prec.shape[-1], dtype=prec.dtype, device=prec.device)
            cov = torch.cholesky_solve(eye, _cholesky(prec))
            return _cholesky(0.5 * (cov + cov.transpose(-1, -2)))
        raise ValueError("MultivariateNormal needs one of covariance_matrix/"
                         "precision_matrix/scale_tril")

    @classmethod
    def noise(cls, g, shape, p):
        return _normal(g, shape)

    @classmethod
    def from_noise(cls, eps, p):
        L = cls._chol(p)
        return p["loc"] + (L @ eps[..., None])[..., 0]

    @classmethod
    def log_prob(cls, x, p):
        L = cls._chol(p)
        d = x.shape[-1]
        diff = x - p["loc"]
        bshape = torch.broadcast_shapes(diff.shape[:-1], L.shape[:-2])
        Lb = torch.broadcast_to(L, bshape + L.shape[-2:])
        diffb = torch.broadcast_to(diff, bshape + diff.shape[-1:])
        sol = torch.linalg.solve_triangular(Lb, diffb[..., None], upper=False)[..., 0]
        maha = torch.sum(sol * sol, dim=-1)
        logdet = torch.sum(torch.log(torch.diagonal(Lb, dim1=-2, dim2=-1)), dim=-1)
        return -0.5 * maha - logdet - d * _HALF_LOG_2PI


class LowRankMultivariateNormal(Family):
    name = "LowRankMultivariateNormal"
    args = (("loc", None), ("cov_factor", None), ("cov_diag", None))
    arg_event_ndim = {"loc": 1, "cov_factor": 2, "cov_diag": 1}
    event_ndim = 1
    support = "real_vector"

    @classmethod
    def _mvn_params(cls, p):
        W = p["cov_factor"]
        cov = W @ W.transpose(-1, -2) + torch.diag_embed(p["cov_diag"])
        return {"loc": p["loc"], "covariance_matrix": cov}

    @classmethod
    def noise(cls, g, shape, p):
        return _normal(g, shape)

    @classmethod
    def from_noise(cls, eps, p):
        return MultivariateNormal.from_noise(eps, cls._mvn_params(p))

    @classmethod
    def log_prob(cls, x, p):
        return MultivariateNormal.log_prob(x, cls._mvn_params(p))


# ---- relaxed (reparameterised) discrete ---------------------------------------------

class LogitRelaxedBernoulli(Family):
    name = "LogitRelaxedBernoulli"
    args = (("temperature", None), ("probs", None), ("logits", None))
    arg_event_ndim = {"temperature": 0, "probs": 0, "logits": 0}
    support = "real"

    @classmethod
    def noise(cls, g, shape, p):
        return _uniform(g, shape)

    @classmethod
    def from_noise(cls, eps, p):
        _, logits = _probs_logits(p)
        return (logits + torch.log(eps) - torch.log1p(-eps)) / p["temperature"]

    @classmethod
    def log_prob(cls, x, p):
        _, logits = _probs_logits(p)
        t = p["temperature"]
        diff = logits - x * t
        return torch.log(t) + diff - 2.0 * tnf.softplus(diff)


class RelaxedBernoulli(Family):
    name = "RelaxedBernoulli"
    args = (("temperature", None), ("probs", None), ("logits", None))
    arg_event_ndim = {"temperature": 0, "probs": 0, "logits": 0}
    support = "unit_interval"

    @classmethod
    def noise(cls, g, shape, p):
        return _uniform(g, shape)

    @classmethod
    def from_noise(cls, eps, p):
        return torch.sigmoid(LogitRelaxedBernoulli.from_noise(eps, p))

    @classmethod
    def log_prob(cls, x, p):
        y = torch.log(x) - torch.log1p(-x)
        return LogitRelaxedBernoulli.log_prob(y, p) - torch.log(x) - torch.log1p(-x)


class RelaxedOneHotCategorical(Family):
    name = "RelaxedOneHotCategorical"
    args = (("temperature", None), ("probs", None), ("logits", None))
    arg_event_ndim = {"temperature": 0, "probs": 1, "logits": 1}
    event_ndim = 1
    support = "simplex"

    @classmethod
    def noise(cls, g, shape, p):
        return _gumbel(g, shape)

    @classmethod
    def from_noise(cls, eps, p):
        _, logits = _cat_probs_logits(p)
        return torch.softmax((logits + eps) / p["temperature"], dim=-1)

    @classmethod
    def log_prob(cls, x, p):
        _, logits = _cat_probs_logits(p)
        t = p["temperature"]
        n = x.shape[-1]
        score = logits - t * torch.log(x)
        score = (torch.sum(score, dim=-1)
                 - n * torch.logsumexp(logits - t * torch.log(x), dim=-1))
        return score + math.lgamma(float(n)) + (n - 1) * torch.log(t)


class Wishart(Family):
    name = "Wishart"
    args = (("df", None), ("covariance_matrix", None), ("precision_matrix", None),
            ("scale_tril", None))
    arg_event_ndim = {"df": 0, "covariance_matrix": 2, "precision_matrix": 2,
                      "scale_tril": 2}
    event_ndim = 2
    support = "pos_def"

    @classmethod
    def _chol(cls, p):
        return MultivariateNormal._chol({k: p.get(k) for k in
                                         ("covariance_matrix", "precision_matrix",
                                          "scale_tril")})

    @classmethod
    def _half_dofs(cls, p, d, device):
        """(df - i) / 2 for the diagonal's rows i, on a last axis of d."""
        df = _tensor(p["df"], device)
        return (df[..., None] - torch.arange(d, dtype=torch.float32, device=device)) / 2.0

    @classmethod
    def noise(cls, g, shape, p):
        # Bartlett's factor: standard normals below the diagonal, and on it
        # the standard gammas at (df - i) / 2 (their doubles are chi-squares)
        d = shape[-1]
        gam = _standard_gamma(g, cls._half_dofs(p, d, g.device), shape[:-1])
        return torch.tril(_normal(g, shape), -1) + torch.diag_embed(gam)

    @classmethod
    def from_noise(cls, eps, p):
        d = eps.shape[-1]
        gam = torch.diagonal(eps, dim1=-2, dim2=-1)
        chi2 = 2.0 * _implicit_gamma(gam, cls._half_dofs(p, d, eps.device))
        A = torch.tril(eps, -1) + torch.diag_embed(torch.sqrt(chi2))
        LA = cls._chol(p) @ A
        return LA @ LA.transpose(-1, -2)

    @classmethod
    def log_prob(cls, x, p):
        L = cls._chol(p)
        d = x.shape[-1]
        df = _tensor(p["df"], x.device)
        V = L @ L.transpose(-1, -2)
        Vinv_x = torch.linalg.solve_ex(torch.broadcast_to(V, x.shape), x,
                                       check_errors=False)[0]
        tr = torch.diagonal(Vinv_x, dim1=-2, dim2=-1).sum(-1)
        _, logdet_x = torch.linalg.slogdet(x)
        logdet_V = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
        lmg = (d * (d - 1) / 4.0) * math.log(math.pi) + torch.sum(
            torch.lgamma((df[..., None] + 1.0
                          - torch.arange(1, d + 1, dtype=torch.float32, device=x.device))
                         / 2.0), dim=-1)
        return (0.5 * (df - d - 1.0) * logdet_x - 0.5 * tr
                - 0.5 * df * d * math.log(2.0) - 0.5 * df * logdet_V - lmg)


class LKJCholesky(Family):
    """Cholesky factor of an LKJ-distributed correlation matrix (onion
    construction; Lewandowski, Kurowicka & Joe 2009)."""
    name = "LKJCholesky"
    args = (("dim", None), ("concentration", 1.0))
    arg_event_ndim = {"dim": 0, "concentration": 0}
    event_ndim = 2
    support = "corr_cholesky"

    @classmethod
    def event_shape(cls, params):
        d = int(params["dim"])
        return (d, d)

    @classmethod
    def _alpha(cls, p, i, d, device):
        return _tensor(p["concentration"], device) + (d - 1 - i) / 2.0

    @classmethod
    def noise(cls, g, shape, p):
        # row i: its direction's standard normals below the diagonal, and on
        # the diagonal its squared norm's Beta(i/2, eta + (d - 1 - i)/2) draw
        d, batch = shape[-1], shape[:-2]
        eps = torch.tril(_normal(g, shape), -1)
        ys = [torch.zeros(batch, device=g.device)]
        for i in range(1, d):
            ys.append(_beta_draw(g, i / 2.0, cls._alpha(p, i, d, g.device), batch))
        return eps + torch.diag_embed(torch.stack(ys, -1))

    @classmethod
    def from_noise(cls, eps, p):
        d = eps.shape[-1]
        rows = [tnf.pad(torch.ones(eps.shape[:-2] + (1,), device=eps.device), (0, d - 1))]
        for i in range(1, d):
            y = _implicit_beta(eps[..., i, i], i / 2.0, cls._alpha(p, i, d, eps.device))
            u = eps[..., i, :i]
            w = torch.sqrt(y)[..., None] * (u / torch.linalg.vector_norm(u, dim=-1,
                                                                          keepdim=True))
            diag = torch.sqrt(torch.clamp(1.0 - y, min=1e-12))[..., None]
            rows.append(tnf.pad(torch.cat([w, diag], -1), (0, d - 1 - i)))
        return torch.stack(rows, -2)

    @classmethod
    def log_prob(cls, x, p):
        d = x.shape[-1]
        eta = _tensor(p["concentration"], x.device)
        diag = torch.diagonal(x, dim1=-2, dim2=-1)
        order = torch.arange(2, d + 1, dtype=torch.float32, device=x.device)
        lp = torch.sum((d - order + 2.0 * eta[..., None] - 2.0)
                       * torch.log(diag[..., 1:]), -1)
        # normalisation (Stan reference manual, lkj_corr_cholesky)
        ks = torch.arange(1, d, dtype=torch.float32, device=x.device)
        alphas = eta[..., None] + (d - 1.0 - ks) / 2.0
        halves = ks / 2.0
        log_norm = torch.sum(halves * math.log(math.pi) + torch.lgamma(alphas)
                             - torch.lgamma(alphas + halves), -1)
        return lp - log_norm


FAMILIES = {f.name: f for f in [
    Normal, HalfNormal, Cauchy, HalfCauchy, LogNormal, Uniform, Exponential,
    Gamma, Chi2, Beta, StudentT, Laplace, Gumbel, Kumaraswamy, Pareto, Weibull,
    FisherSnedecor, VonMises, Bernoulli, ContinuousBernoulli, Binomial, Poisson,
    Geometric, NegativeBinomial, Categorical, OneHotCategorical, Multinomial,
    Dirichlet, MultivariateNormal, LowRankMultivariateNormal,
    LogitRelaxedBernoulli, RelaxedBernoulli, RelaxedOneHotCategorical, Wishart,
    LKJCholesky,
]}
