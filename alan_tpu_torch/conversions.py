"""Exponential-family conversions between mean (moment) parameters and
conventional parameters, used by the QEM update (counterpart of
``alan_tpu/conversions.py``): Minka's fixed-point and Newton iterations for
the Dirichlet, the Beta and the Gamma, with the same fixed counts, so a
conversion runs no loop that stops on the data.  All math is elementwise
on dimmed tensors.
"""
from __future__ import annotations

import torch

from .dims import as_dt, elementwise as ew
from .moments import mean, mean2, mean_log, mean_log1m, mean_xxT, vec_square
from .distributions import families as F

#: digamma(1), minus the Euler-Mascheroni constant
_DIGAMMA_1 = -0.5772156649015329


def _polygamma1(a):
    return torch.polygamma(1, a)


def grad_digamma(x):
    return ew(_polygamma1, x)


def inverse_digamma(y):
    """Solve digamma(x) = y (Minka, Appendix C); 6 Newton steps."""
    y = as_dt(y)
    x_big = ew(lambda v: torch.exp(v) + 0.5, y)
    x_small = ew(lambda v: -1.0 / (v - _DIGAMMA_1), y)
    x = ew(lambda v, b, s: torch.where(v > -2.22, b, s), y, x_big, x_small)
    for _ in range(6):
        x = ew(lambda xx, yy: xx - (torch.digamma(xx) - yy) / _polygamma1(xx), x, y)
    return x


class AbstractConversion:
    @staticmethod
    def canonical_conv(**kwargs):
        return kwargs


class BernoulliConversion(AbstractConversion):
    family = F.Bernoulli
    sufficient_stats = (mean,)

    @staticmethod
    def conv2mean(probs):
        return (as_dt(probs),)

    @staticmethod
    def mean2conv(mean):
        return {"probs": as_dt(mean)}

    @staticmethod
    def canonical_conv(logits=None, probs=None):
        assert (probs is None) != (logits is None)
        return {"probs": ew(torch.sigmoid, logits) if logits is not None else probs}


class ContinuousBernoulliConversion(BernoulliConversion):
    family = F.ContinuousBernoulli


class PoissonConversion(AbstractConversion):
    family = F.Poisson
    sufficient_stats = (mean,)

    @staticmethod
    def conv2mean(rate):
        return (as_dt(rate),)

    @staticmethod
    def mean2conv(mean):
        return {"rate": as_dt(mean)}


class NormalConversion(AbstractConversion):
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


class ExponentialConversion(AbstractConversion):
    family = F.Exponential
    sufficient_stats = (mean,)

    @staticmethod
    def conv2mean(rate):
        return (ew(torch.reciprocal, rate),)

    @staticmethod
    def mean2conv(mean):
        return {"rate": ew(torch.reciprocal, mean)}


class DirichletConversion(AbstractConversion):
    family = F.Dirichlet
    sufficient_stats = (mean_log,)

    @staticmethod
    def conv2mean(concentration):
        return (ew(lambda c: torch.digamma(c)
                   - torch.digamma(torch.sum(c, -1, keepdim=True)), concentration),)

    @staticmethod
    def mean2conv(logp):
        logp = as_dt(logp)
        alpha = ew(torch.ones_like, logp)
        # slow-but-safe fixed point, then fast Newton (Minka Eqs. 9, 15-18)
        for _ in range(5):
            alpha = inverse_digamma(ew(
                lambda a, lp: torch.digamma(torch.sum(a, -1, keepdim=True)) + lp,
                alpha, logp))

        def newton(a, lp):
            sum_a = torch.sum(a, -1, keepdim=True)
            g = torch.digamma(sum_a) - torch.digamma(a) + lp
            z = _polygamma1(sum_a)
            q = -_polygamma1(a)
            b = (torch.sum(g / q, -1, keepdim=True)
                 / (1.0 / z + torch.sum(1.0 / q, -1, keepdim=True)))
            return a - (g - b) / q
        for _ in range(6):
            alpha = ew(newton, alpha, logp)
        return {"concentration": alpha}


class BetaConversion(AbstractConversion):
    family = F.Beta
    sufficient_stats = (mean_log, mean_log1m)

    @staticmethod
    def conv2mean(concentration1, concentration0):
        c1, c0 = as_dt(concentration1), as_dt(concentration0)
        norm = ew(torch.digamma, c1 + c0)
        return (ew(torch.digamma, c1) - norm, ew(torch.digamma, c0) - norm)

    @staticmethod
    def mean2conv(Elogx, Elog1mx):
        logp = ew(lambda a, b: torch.stack([a, b], -1), as_dt(Elogx), as_dt(Elog1mx))
        c = DirichletConversion.mean2conv(logp)["concentration"]
        return {"concentration1": ew(lambda x: x[..., 0], c),
                "concentration0": ew(lambda x: x[..., 1], c)}


class GammaConversion(AbstractConversion):
    family = F.Gamma
    sufficient_stats = (mean_log, mean)

    @staticmethod
    def conv2mean(concentration, rate):
        a, b = as_dt(concentration), as_dt(rate)
        return (ew(lambda aa, bb: -torch.log(bb) + torch.digamma(aa), a, b), a / b)

    @staticmethod
    def mean2conv(Elogx, Ex):
        """Minka's generalised Newton (minka-gamma Eq. 10)."""
        Elogx, Ex = as_dt(Elogx), as_dt(Ex)

        def solve(elog, ex):
            diff = elog - torch.log(ex)
            alpha = -0.5 / diff
            for _ in range(6):
                num = diff + torch.log(alpha) - torch.digamma(alpha)
                denom = 1.0 - alpha * _polygamma1(alpha)
                alpha = alpha / (1.0 + num / denom)
            return alpha
        alpha = ew(solve, Elogx, Ex)
        return {"concentration": alpha, "rate": alpha / Ex}


class MultivariateNormalConversion(AbstractConversion):
    family = F.MultivariateNormal
    sufficient_stats = (mean, mean_xxT)

    @staticmethod
    def conv2mean(loc, covariance_matrix):
        loc, cov = as_dt(loc), as_dt(covariance_matrix)
        return (loc, cov + vec_square(loc))

    @staticmethod
    def mean2conv(Ex, Ex2):
        Ex, Ex2 = as_dt(Ex), as_dt(Ex2)
        return {"loc": Ex, "covariance_matrix": Ex2 - vec_square(Ex)}

    @staticmethod
    def canonical_conv(loc, covariance_matrix=None, precision_matrix=None,
                       scale_tril=None):
        assert 1 == sum(x is not None for x in
                        [covariance_matrix, precision_matrix, scale_tril])
        if precision_matrix is not None:
            covariance_matrix = ew(lambda P: torch.linalg.inv_ex(P, check_errors=False)[0],
                                   precision_matrix)
        elif scale_tril is not None:
            covariance_matrix = ew(lambda L: L @ L.transpose(-1, -2), scale_tril)
        return {"loc": loc, "covariance_matrix": covariance_matrix}


class HalfNormalConversion(AbstractConversion):
    family = F.HalfNormal
    sufficient_stats = (mean2,)

    @staticmethod
    def conv2mean(scale):
        s = as_dt(scale)
        return (s * s,)

    @staticmethod
    def mean2conv(mean2):
        return {"scale": ew(torch.sqrt, as_dt(mean2))}


conversion_dict = {
    F.Bernoulli: BernoulliConversion,
    F.ContinuousBernoulli: ContinuousBernoulliConversion,
    F.Beta: BetaConversion,
    F.Dirichlet: DirichletConversion,
    F.Poisson: PoissonConversion,
    F.Exponential: ExponentialConversion,
    F.Normal: NormalConversion,
    F.Gamma: GammaConversion,
    F.MultivariateNormal: MultivariateNormalConversion,
    F.HalfNormal: HalfNormalConversion,
}
