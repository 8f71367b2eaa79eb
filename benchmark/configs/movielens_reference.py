"""Plain reference of a MovieLens training step (``movielens.py`` beside
this file), in plain PyTorch: the densities written out, the
massively-parallel ELBO as explicit sums over particle indices, QEM's
moments or VI's gradient from autograd, the QEM update or Adam's.  It
imports nothing of the program and takes nothing the program made.

The model (alan-ppl/alan ``examples/models/movielens/movielens.py``):
mu_z ~ N(0, 1)^18, psi_z ~ N(0, 1)^18; per user m, z_m ~ N(mu_z,
exp(psi_z)); per user and film, obs_mn ~ Bernoulli(logits z_m . x_mn).
Q is a factorised Normal per latent with K particles each.

``factorised``: mu_z, psi_z and z have particle indices a, b, k:

    ELBO = log sum_ab exp(f_a + f_b + sum_m log sum_k exp(f_mkab + o_mk))

``grouped``: mu_z and psi_z share one index g:

    ELBO = log sum_g exp(f_g + sum_m log sum_k exp(f_mkg + o_mk))

with f = log P - log Q - log K of each group and o_mk = sum_n log
Bernoulli(obs_mn | z_mk . x_mn).  z's density against its parents' every
particle is written in its expanded form, sum_f -z^2 / (2 s^2) + z mu / s^2
- mu^2 / (2 s^2) - log s - log(2 pi) / 2, one matrix product over the
features (in float64 the expansion loses nothing).

QEM: E[x], E[x^2] are the particles' marginal weights (gradients of the
ELBO with respect to zero log-factors) times x and x^2; the averages move
by ``lr``, loc = m1, scale = sqrt(max(m2 - m1^2, tiny)).  VI: particles
loc + exp(log_scale) * eps, the gradient of the ELBO with respect to loc
and log_scale through them; Adam (betas 0.9, 0.999, eps 1e-8) ascends it.

Particles: the draws of the port's step, from a generator seeded with
``--seed``, in its order: per step standard normals of shapes (K, 18),
(K, 18), (K, M, 18).
"""
from __future__ import annotations

import math

import torch

LATENTS = ("mu_z", "psi_z", "z")
HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)
BETAS, EPS = (0.9, 0.999), 1e-8


def tf32(x):
    """``x`` (float32) rounded to TF32's 10-bit mantissa, as the tensor
    cores take a TF32 product's operands."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def normal_lp(x, loc, scale):
    z = (x - loc) / scale
    return -0.5 * z * z - torch.log(scale) - HALF_LOG_2PI


def z_density(z, mu, psi, op):
    """sum_f log N(z[k, m, f] | mu[a, f], exp(psi[b, f])) as [m, k, a, b]
    (``psi`` None: mu and psi of one index, [m, k, g]); ``op`` takes each
    operand of a matrix product."""
    K, M, F = z.shape
    z2 = z.permute(1, 0, 2).reshape(M * K, F)
    if psi is None:
        prec = torch.exp(-2.0 * mu[1])                           # [g, f]
        m = mu[0]
        feats = torch.cat([-0.5 * z2 * z2, z2], dim=-1)          # [mk, 2f]
        coef = torch.cat([prec, m * prec], dim=-1)               # [g, 2f]
        const = (-0.5 * m * m * prec - mu[1]).sum(-1) - F * HALF_LOG_2PI
        return (op(feats) @ op(coef.T) + const).reshape(M, K, -1)
    A, B = mu.shape[0], psi.shape[0]
    prec = torch.exp(-2.0 * psi)                                 # [b, f]
    sq = op(-0.5 * z2 * z2) @ op(prec.T)                              # [mk, b]
    cross = op(z2) @ op((mu[:, None, :] * prec[None, :, :]).reshape(A * B, F).T)
    const = ((-0.5 * mu[:, None, :] ** 2 * prec[None]).sum(-1)
             - psi.sum(-1)[None, :] - F * HALF_LOG_2PI)          # [a, b]
    return (sq[:, None, :] + cross.reshape(M * K, A, B) + const).reshape(M, K, A, B)


class Reference:
    """``run(seed, steps)`` follows the port's steps from Q's initial
    state.  ``dtype`` is the arithmetic's (float64; the control takes
    float32), ``tf32`` rounds the operands of its matrix products to TF32
    (the control: float32 products on the tensor cores)."""

    def __init__(self, cfg, data, traffic, device, dtype=torch.float64, tf32=False):
        self.traffic, self.dtype, self.tf32 = traffic, dtype, tf32
        self.K, self.lr = traffic["K"], traffic["lr"]
        self.M, self.F = cfg["M"], cfg["d_z"]
        self.device = torch.device(device)
        self.x = torch.as_tensor(data["x"], device=self.device).to(dtype)
        self.obs = torch.as_tensor(data["obs"], device=self.device).to(dtype)
        self.grouped = traffic["q"] == "grouped"
        if traffic["method"] not in ("qem", "vi"):
            raise ValueError(f"no reference for {traffic['method']!r}")

    def _shape(self, k):
        return (self.M, self.F) if k == "z" else (self.F,)

    def draw(self, loc, scale, gen):
        out = {}
        for k in LATENTS:
            eps = torch.randn((self.K, *self._shape(k)), generator=gen, device=gen.device)
            out[k] = (loc[k], scale[k], eps)
        return out

    def elbo(self, x, loc, scale, extra=None):
        """The ELBO of particles ``x`` (by latent, laid out as drawn) under
        Q at ``loc``, ``scale``; ``extra`` adds a log-factor to each
        latent's particles (the zero terms whose gradients are weights)."""
        dt, K = self.dtype, self.K
        logK = math.log(K)
        if extra is None:
            extra = {k: torch.zeros(x[k].shape[:-1], dtype=dt, device=self.device)
                     for k in LATENTS}
        f = {k: (normal_lp(x[k], 0.0 * x[k], torch.ones_like(x[k]))
                 - normal_lp(x[k], loc[k], scale[k])).sum(-1) + extra[k]
             for k in ("mu_z", "psi_z")}                         # [K]
        lq_z = normal_lp(x["z"], loc["z"], scale["z"]).sum(-1).T  # [m, k]
        op = tf32 if self.tf32 else (lambda v: v)
        logits = torch.einsum("kmf,mnf->mkn", op(x["z"]), op(self.x))
        ob = (self.obs[:, None, :] * logits - torch.nn.functional.softplus(logits)).sum(-1)
        zk = ob - lq_z - logK + extra["z"].T                     # [m, k]
        if self.grouped:
            zf = z_density(x["z"], (x["mu_z"], x["psi_z"]), None, op)   # [m, k, g]
            h = torch.logsumexp(zf + zk[..., None], dim=1).sum(0)   # [g]
            return torch.logsumexp(f["mu_z"] + f["psi_z"] - logK + h, dim=0)
        zf = z_density(x["z"], x["mu_z"], x["psi_z"], op)          # [m, k, a, b]
        h = torch.logsumexp(zf + zk[..., None, None], dim=1).sum(0)  # [a, b]
        return torch.logsumexp((f["mu_z"][:, None] - logK + f["psi_z"][None, :] - logK
                                + h).reshape(-1), dim=0)

    # ---- QEM ---------------------------------------------------------------
    def _qem_step(self, means, gen):
        tiny = torch.finfo(torch.float32).tiny
        loc = {k: m1.float() for k, (m1, m2) in means.items()}
        scale = {k: torch.sqrt(torch.clamp(m2 - m1 * m1, min=tiny)).float()
                 for k, (m1, m2) in means.items()}
        x, locs, scales = {}, {}, {}
        for k, (l, s, eps) in self.draw(loc, scale, gen).items():
            x[k] = (l + s * eps).to(self.dtype)
            locs[k], scales[k] = l.to(self.dtype), s.to(self.dtype)
        e = {k: torch.zeros(x[k].shape[:-1], dtype=self.dtype, device=self.device,
                            requires_grad=True) for k in LATENTS}
        elbo = self.elbo(x, locs, scales, e)
        ws = dict(zip(LATENTS, torch.autograd.grad(elbo, [e[k] for k in LATENTS])))
        lr = self.lr
        new = {}
        for k, (m1, m2) in means.items():
            w = ws[k][..., None]
            new[k] = ((1 - lr) * m1 + lr * (w * x[k]).sum(0).double(),
                      (1 - lr) * m2 + lr * (w * x[k] * x[k]).sum(0).double())
        return float(elbo.detach()), new

    @staticmethod
    def _qem_leaves(means):
        tiny = torch.finfo(torch.float32).tiny
        out = {}
        for k, (m1, m2) in means.items():
            out[f"{k}_loc"] = m1.float().double().cpu()
            out[f"{k}_scale"] = torch.sqrt(torch.clamp(m2 - m1 * m1, min=tiny)).float().double().cpu()
        return out

    # ---- VI ----------------------------------------------------------------
    def _vi_step(self, leaves, adam, t, gen):
        params = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
        draws = self.draw({k: params[f"{k}_loc"].detach().float() for k in LATENTS},
                          {k: params[f"{k}_scale"].detach().float() for k in LATENTS}, gen)
        loc = {k: params[f"{k}_loc"] for k in LATENTS}
        scale = {k: torch.exp(params[f"{k}_scale"]) for k in LATENTS}
        x = {k: loc[k] + scale[k] * draws[k][2].to(self.dtype) for k in LATENTS}
        elbo = self.elbo(x, loc, scale)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(elbo, [params[n] for n in names])))
        b1, b2 = BETAS
        new = {}
        with torch.no_grad():
            for n in names:
                g = -grads[n]
                m, v = adam.get(n, (torch.zeros_like(g), torch.zeros_like(g)))
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * g * g
                adam[n] = (m, v)
                denom = (v / (1 - b2 ** t)).sqrt() + EPS
                new[n] = leaves[n] - self.lr * (m / (1 - b1 ** t)) / denom
        return float(elbo.detach()), new, grads

    def run(self, seed, steps):
        """``(elbos, leaves, first)``: each step's ELBO, Q's parameters
        before the first step and after each (float64 on the host), and
        VI's first gradient of the ELBO by leaf (None for QEM)."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        elbos, first = [], None
        if self.traffic["method"] == "qem":
            means = {}
            for k in LATENTS:
                zero = torch.zeros(self._shape(k), dtype=torch.float64, device=self.device)
                means[k] = (zero, zero + 1.0)
            leaves = [self._qem_leaves(means)]
            for _ in range(steps):
                elbo, means = self._qem_step(means, gen)
                elbos.append(elbo)
                leaves.append(self._qem_leaves(means))
            return elbos, leaves, None
        state = {}
        for k in LATENTS:
            state[f"{k}_loc"] = torch.zeros(self._shape(k), dtype=self.dtype,
                                            device=self.device)
            state[f"{k}_scale"] = torch.zeros_like(state[f"{k}_loc"])
        host = lambda d: {k: v.detach().to("cpu", torch.float64) for k, v in d.items()}
        leaves, adam = [host(state)], {}
        for t in range(1, steps + 1):
            elbo, state, grads = self._vi_step(state, adam, t, gen)
            elbos.append(elbo)
            leaves.append(host(state))
            if first is None:
                first = host(grads)
        return elbos, leaves, first
