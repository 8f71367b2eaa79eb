"""Plain reference of a covid QEM training step (``covid.py`` beside this
file), in plain PyTorch: the model's densities written out, the
massively-parallel ELBO as explicit sums over particle indices, the
posterior moments from autograd, the QEM update.  It imports nothing of
the program and takes nothing the program made: the data arrays and the
seed are the benchmark's.

The model (alan-ppl/alan ``examples/models/covid/covid.py``), per region r
and day t:

    CM_alpha ~ N(0, 1)^9, Wearing_alpha ~ N(0, 0.4),
    Mobility_alpha ~ N(1.704, 0.44), RegionR ~ N(1.07, 0.6),
    InitialSize_log_mean ~ N(log 1000, 0.5),
    log_infected_noise_mean ~ N(log 0.01, 0.25);
    InitialSize_log_r ~ N(InitialSize_log_mean, 0.5),
    log_infected_noise_r ~ N(log_infected_noise_mean, 0.25), psi_r ~ N(0, 1);
    log_infected_rt ~ N(RegionR + CM_alpha . npis_rt + Wearing_alpha w_rt
                        + Mobility_alpha m_rt + log_infected_r(t-1),
                        exp(log_infected_noise_r)),
        with log_infected_r(-1) = InitialSize_log_r;
    obs_rt ~ NegativeBinomial(exp(psi_r), 1 / (exp(psi_r) / exp(log_infected_rt) + 1 + 1e-7)).

Q is a factorised Normal per latent (per region, per region and day), with
K = 30 particles each: the six global latents share one particle index n,
the three per-region latents one index a, log_infected one index j per
(r, t).  The massively-parallel ELBO sums the particle indices:

    ELBO = log sum_n exp(f_n + sum_r log sum_a exp(f_ra,n + chain_ra,n)),

where f are log P - log Q - log K of each group, and chain_ra,n is the
log of the sum over the day-by-day indices of the product of the day
factors M_rt(i, j) = log N(x_rtj | mu_rt,n + prev_i, exp(noise_ri))
- log Q(x_rtj) - log K + log NB(obs_rt | psi_ri, x_rtj): on day 0 the row
index i is the region's particle a (prev = InitialSize_log_ra), on a later
day the previous day's particle, whose index also picks the region's
noise and psi (the model's timeseries convention: one row index per day).
The transition density against every pair of parent particles is written
in its expanded form, -x^2 / (2 s^2) + x m / s^2 - m^2 / (2 s^2) - log s -
log(2 pi) / 2, one matrix product over the features (in float64 the
expansion loses nothing).  The chain is summed day by day with the full
logsumexp of every cross sum, so no entry loses precision to a shift.

QEM: each latent's posterior moments E[x], E[x^2] are the marginal
weights of its particles (the gradient of the ELBO with respect to a zero
log-factor on each particle) times x and x^2; the moment averages move by
``lr`` and Q's loc and scale follow, scale = sqrt(max(m2 - m1^2, tiny)).

Particles: the same draws the port's step makes, from a generator seeded
with ``--seed``, in its order: per step standard normals of shapes
(K, 9), then (K,) five times, (K, nRs) three times, (K, nRs, nDs), each
``loc + scale * eps`` in float32.
"""
from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

GLOBALS = ("CM_alpha", "Wearing_alpha", "Mobility_alpha", "RegionR",
           "InitialSize_log_mean", "log_infected_noise_mean")
REGION = ("InitialSize_log", "log_infected_noise", "psi")
PRIORS = {"CM_alpha": (0.0, 1.0), "Wearing_alpha": (0.0, 0.4),
          "Mobility_alpha": (1.704, 0.44), "RegionR": (1.07, 0.6),
          "InitialSize_log_mean": (math.log(1000), 0.5),
          "log_infected_noise_mean": (math.log(0.01), 0.25)}
#: Q's initial locations (scales start at 1)
LOC0 = {"CM_alpha": 0.0, "Wearing_alpha": 0.0, "Mobility_alpha": 0.0,
        "RegionR": 1.0, "InitialSize_log_mean": math.log(1000),
        "log_infected_noise_mean": math.log(0.01),
        "InitialSize_log": math.log(1000), "log_infected_noise": math.log(0.01),
        "psi": 0.0, "log_infected": math.log(1000)}
HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def normal_lp(x, loc, scale):
    z = (x - loc) / scale
    return -0.5 * z * z - torch.log(torch.as_tensor(scale, dtype=x.dtype, device=x.device)) \
        - HALF_LOG_2PI


def negbin_lp(k, r, p):
    return (torch.lgamma(k + r) - torch.lgamma(r) - torch.lgamma(k + 1.0)
            + torch.xlogy(r, 1.0 - p) + torch.xlogy(k, p))


def tf32(x):
    """``x`` (float32) rounded to TF32's 10-bit mantissa, as the tensor
    cores take a TF32 product's operands."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _logmatmul(s, m):
    """log sum_k exp(s[..., i, k] + m[..., k, j]), the whole cross sum."""
    return torch.logsumexp(s.unsqueeze(-1) + m.unsqueeze(-3), dim=-2)


class Reference:
    """``run(seed, steps)`` follows the port's QEM steps from Q's initial
    state.  ``dtype`` is the arithmetic's (float64; the control takes
    float32), ``tf32`` rounds the operands of its matrix products to TF32
    (the control: float32 products on the tensor cores)."""

    def __init__(self, cfg, data, traffic, device, dtype=torch.float64, tf32=False):
        if traffic["method"] != "qem":
            raise ValueError("the covid reference trains by QEM")
        self.K, self.lr = traffic["K"], traffic["lr"]
        self.nRs, self.T = cfg["nRs"], cfg["nDs_train"]
        self.device, self.dtype, self.tf32 = torch.device(device), dtype, tf32
        T = self.T
        as_t = lambda a: torch.as_tensor(a[:, :T], device=self.device).to(dtype)
        self.npis, self.wearing = as_t(data["npis"]), as_t(data["wearing"])
        self.mobility, self.obs = as_t(data["mobility"]), as_t(data["obs"])

    # ---- Q -----------------------------------------------------------------
    def initial(self):
        """Q's moment averages (m1, m2) by latent, in float64."""
        shapes = {"CM_alpha": (self.npis.shape[-1],)}
        shapes.update({k: () for k in GLOBALS[1:]})
        shapes.update({k: (self.nRs,) for k in REGION})
        shapes["log_infected"] = (self.nRs, self.T)
        means = {}
        for k, shp in shapes.items():
            loc = torch.full(shp, LOC0[k], dtype=torch.float64, device=self.device)
            means[k] = (loc, loc * loc + 1.0)
        return means

    @staticmethod
    def params(means):
        """loc and scale by latent, float32 as the program keeps them."""
        tiny = torch.finfo(torch.float32).tiny
        out = {}
        for k, (m1, m2) in means.items():
            out[f"{k}_loc"] = m1.float()
            out[f"{k}_scale"] = torch.sqrt(torch.clamp(m2 - m1 * m1, min=tiny)).float()
        return out

    def draw(self, params, gen):
        K, nRs, T = self.K, self.nRs, self.T
        shapes = [("CM_alpha", (K, self.npis.shape[-1]))]
        shapes += [(k, (K,)) for k in GLOBALS[1:]]
        shapes += [(k, (K, nRs)) for k in REGION]
        shapes += [("log_infected", (K, nRs, T))]
        x = {}
        for k, shp in shapes:
            eps = torch.randn(shp, generator=gen, device=gen.device)
            x[k] = params[f"{k}_loc"] + params[f"{k}_scale"] * eps
        return x

    # ---- the ELBO and the marginal weights -----------------------------------
    def elbo_and_weights(self, params, x):
        """(ELBO, weights): the weights of each latent's particles, laid
        out as its draw, by autograd of the ELBO with respect to zero
        log-factors."""
        dt, K = self.dtype, self.K
        logK = math.log(K)
        p = {k: v.to(dt) for k, v in params.items()}
        x = {k: v.to(dt) for k, v in x.items()}
        lq = lambda k, v: normal_lp(v, p[f"{k}_loc"], p[f"{k}_scale"])

        # the six global latents: index n
        f_n = -logK
        for k in GLOBALS:
            lp = normal_lp(x[k], *PRIORS[k]) - lq(k, x[k])
            f_n = f_n + (lp.sum(-1) if k == "CM_alpha" else lp)
        # the region's latents: [r, a, n]
        isl, noise, psi = (x[k].T for k in REGION)               # [r, a]
        f_a = (normal_lp(isl[..., None], x["InitialSize_log_mean"], 0.5)
               + normal_lp(noise[..., None], x["log_infected_noise_mean"], 0.25)
               + normal_lp(psi, 0.0, 1.0)[..., None]
               - sum(lq(k, x[k]).T for k in REGION)[..., None] - logK)

        # the day factors M[r, n, t, i, j]
        op = tf32 if self.tf32 else (lambda v: v)
        li = x["log_infected"].permute(1, 2, 0)                  # [r, t, j]
        cm = torch.einsum("rtc,nc->rtn", op(self.npis), op(x["CM_alpha"]))
        mu = (x["RegionR"] + cm + x["Wearing_alpha"] * self.wearing[..., None]
              + x["Mobility_alpha"] * self.mobility[..., None])  # [r, t, n]
        prev = torch.cat([isl[:, None, :], li[:, :-1, :]], dim=1)  # [r, t, i]
        sd = torch.exp(noise)                                    # [r, i]
        lq_li = normal_lp(li, p["log_infected_loc"][..., None],
                          p["log_infected_scale"][..., None])    # [r, t, j]
        r_nb = torch.exp(psi)                                    # [r, i]
        probs = 1.0 / (r_nb[:, None, :, None] / torch.exp(li)[:, :, None, :] + 1 + 1e-7)
        obs_lp = negbin_lp(self.obs[:, :, None, None], r_nb[:, None, :, None], probs)
        # the transition density against every (n, i) pair of parents, in
        # its expanded form: one matrix product over the features x^2, x
        loc = mu.permute(0, 2, 1)[..., None] + prev[:, None]    # [r, n, t, i]
        prec = (1.0 / (sd * sd))[:, None, None, :]               # [r, 1, 1, i]
        coef = torch.stack([-0.5 * prec.expand_as(loc), loc * prec], dim=-1)
        feats = torch.stack([li * li, li], dim=-2)[:, None]      # [r, 1, t, 2, j]
        const = -0.5 * loc * loc * prec - torch.log(sd)[:, None, None, :] - HALF_LOG_2PI
        M = (torch.matmul(op(coef), op(feats)) + const[..., None]
             + (obs_lp - lq_li[:, :, None, :] - logK)[:, None])  # [r, n, t, i, j]
        del coef, feats, const, obs_lp, probs

        e_n = torch.zeros(K, dtype=dt, device=self.device, requires_grad=True)
        e_a = torch.zeros(self.nRs, K, dtype=dt, device=self.device, requires_grad=True)
        e_j = torch.zeros(self.nRs, self.T, K, dtype=dt, device=self.device,
                          requires_grad=True)
        M = M.detach() + e_j[:, None, :, None, :]
        s = M[:, :, 0]
        for t in range(1, self.T):
            s = torch.utils.checkpoint.checkpoint(_logmatmul, s, M[:, :, t],
                                                  use_reentrant=False)
        chain = torch.logsumexp(s, dim=-1)                       # [r, n, i]
        g = torch.logsumexp(f_a.detach().permute(0, 2, 1) + e_a[:, None, :] + chain,
                            dim=-1)                              # [r, n]
        elbo = torch.logsumexp(f_n.detach() + e_n + g.sum(0), dim=0)
        w_n, w_a, w_j = torch.autograd.grad(elbo, (e_n, e_a, e_j))
        weights = {k: w_n for k in GLOBALS}
        weights.update({k: w_a.T for k in REGION})               # [a, r]
        weights["log_infected"] = w_j.permute(2, 0, 1)           # [j, r, t]
        return elbo.detach(), weights

    def moments(self, x, weights):
        out = {}
        for k, v in x.items():
            v = v.to(self.dtype)
            w = weights[k]
            if v.dim() > w.dim():
                w = w[..., None]
            out[k] = ((w * v).sum(0), (w * v * v).sum(0))
        return out

    def run(self, seed, steps):
        """``(elbos, leaves, first)``: each step's ELBO, Q's parameters
        before the first step and after each (float64 on the host), and
        no optimizer gradient (QEM keeps none)."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        means = self.initial()
        host = lambda ps: {k: v.to("cpu", torch.float64) for k, v in ps.items()}
        params = self.params(means)
        leaves, elbos = [host(params)], []
        for _ in range(steps):
            x = self.draw(params, gen)
            elbo, weights = self.elbo_and_weights(params, x)
            moms = self.moments(x, weights)
            lr = self.lr
            means = {k: ((1 - lr) * m1 + lr * moms[k][0].double(),
                         (1 - lr) * m2 + lr * moms[k][1].double())
                     for k, (m1, m2) in means.items()}
            params = self.params(means)
            elbos.append(float(elbo))
            leaves.append(host(params))
        return elbos, leaves, None
