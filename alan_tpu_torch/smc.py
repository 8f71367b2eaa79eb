"""Sequential Monte Carlo with adaptive likelihood tempering (counterpart of
``alan_tpu/smc.py``): particles in unconstrained space, the next
temperature by bisection to hold the incremental ESS at a share of the
particles, systematic resampling and random-walk Metropolis mutations, with
an estimate of the log evidence.

The particles are the batch axis of ``mcmc.LogPost`` (its ``chain`` dim).
The bisection is a host loop that reads a number off the device at each
of its steps, as ``alan_tpu``'s does: up to 32 reads a stage (one at
lambda = 1, 30 bisection steps, the stage's log-evidence increment), the
sampler's only host syncs.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .bound import BoundPlate
from .ir.plate import flatten_tree
from .mcmc import LogPost, _unconstrain, _walk
from .sampler import IndependentSampler
from .utils import seeded_generator


def log_prior_lik(P: BoundPlate, latents: dict, data: dict):
    """(log prior, log likelihood) of the P program, per particle (the
    latents' ``chain`` dim)."""
    parts = {"prior": 0.0, "lik": 0.0}

    def add(kind, lp):
        parts[kind] = parts[kind] + lp
    _walk(P, latents, data, add)
    return torch.as_tensor(parts["prior"]), torch.as_tensor(parts["lik"])


def _split_logp(logpost, theta):
    """(log prior with the transforms' log|det J|, log likelihood) of a
    (particle, D) batch."""
    latents, logdet = logpost.constrain(theta)
    prior, lik = log_prior_lik(logpost.P, latents, logpost.data)
    return prior + logdet, lik


def _systematic_resample(u, logw, n):
    """Systematic resampling at the uniform ``u``: indices (n,)."""
    w = torch.softmax(logw, dim=0)
    positions = (u + torch.arange(n, dtype=logw.dtype, device=logw.device)) / n
    idx = torch.searchsorted(torch.cumsum(w, dim=0), positions)
    # a rounding shortfall of the cumulative sum must not index past the end
    return torch.clamp(idx, max=n - 1)


def _prior_particles(logpost, n, generator):
    """``n`` prior draws, unconstrained, as (n, D): one batched draw of the
    program with ``n`` joint particles (``IndependentSampler``: particle k
    of a latent conditions on particle k of its parents), the distribution
    of ``n`` draws of ``BoundPlate.sample``."""
    P = logpost.P
    tree, gv2K = P._sample(n, False, IndependentSampler, dict(P.all_platesizes),
                           generator)
    flat = flatten_tree(tree)
    v2g = P.plate.varname2groupvarname()
    parts = []
    for name, dims, _, _, _ in logpost.layout:
        x = flat[name].with_dims_front([gv2K[v2g[name]], *dims])
        parts.append(_unconstrain(logpost.trans[name], x.data).reshape(n, -1))
    return torch.cat(parts, dim=1)


def run_smc(P: BoundPlate, data: dict, num_particles=512, mutation_steps=4,
            step_size=0.1, ess_threshold=0.5, max_stages=50, generator=None,
            latents=None, particles=None, noise=None):
    """Returns ``(samples, info)``: each latent a DT with a ``particle`` dim
    in front of its plates, and ``info['log_Z']`` the evidence estimate.
    ``particles`` (num_particles, D) replaces the initial prior draws, laid
    out as ``mcmc.LogPost`` lays out ``latents`` (default: a prior draw);
    ``noise`` the generator's draws, each with a leading stage axis:
    ``resample`` (stage,) uniforms, ``normals`` (stage, mutation_steps,
    particle, D) and ``uniforms`` (stage, mutation_steps, particle)."""
    device = P.device
    if generator is None:
        generator = seeded_generator(0, device)
    logpost = LogPost(P, data, latents, seeded_generator(0, device))
    N = num_particles
    if particles is None:
        thetas = _prior_particles(logpost, N, generator)
    else:
        thetas = torch.as_tensor(np.array(particles, np.float32)).to(device)
    if noise is not None:
        noise = {k: torch.as_tensor(np.array(v)).to(device) for k, v in noise.items()}

    lam, log_Z, stages, syncs = 0.0, 0.0, 0, 0
    for stage in range(max_stages):
        with torch.no_grad():
            _, lik = _split_logp(logpost, thetas)
        log_N = math.log(N)

        def ess_at(l_new):
            lw = (l_new - lam) * lik
            lw = lw - torch.logsumexp(lw, dim=0)
            return float(torch.exp(-torch.logsumexp(2 * lw, dim=0)) / N)

        lo, hi = lam, 1.0
        syncs += 1
        if ess_at(1.0) >= ess_threshold:
            lam_new = 1.0
        else:
            for _ in range(30):
                mid = 0.5 * (lo + hi)
                syncs += 1
                if ess_at(mid) >= ess_threshold:
                    lo = mid
                else:
                    hi = mid
            lam_new = lo

        lw = (lam_new - lam) * lik
        syncs += 1
        log_Z += float(torch.logsumexp(lw, dim=0) - log_N)

        if noise is not None:
            u_rs = noise["resample"][stage]
        else:
            u_rs = torch.rand((), generator=generator, device=device)
        thetas = thetas[_systematic_resample(u_rs, lw, N)]
        lam = lam_new
        stages += 1

        # random-walk Metropolis steps on the tempered target
        def tempered(th, lam=lam):
            p, l = _split_logp(logpost, th)
            return p + lam * l

        accs = []
        with torch.no_grad():
            lp = tempered(thetas)
            for s in range(mutation_steps):
                if noise is not None:
                    eps, u = noise["normals"][stage, s], noise["uniforms"][stage, s]
                else:
                    eps = torch.randn(thetas.shape, generator=generator, device=device)
                    u = torch.rand((N,), generator=generator, device=device)
                prop = thetas + step_size * eps
                lp_prop = tempered(prop)
                acc = torch.log(u) < lp_prop - lp
                thetas = torch.where(acc[:, None], prop, thetas)
                lp = torch.where(acc, lp_prop, lp)
                accs.append(acc.float().mean())
        if lam >= 1.0:
            break

    samples = logpost.samples(thetas, lead=("particle",))
    info = {"log_Z": log_Z, "stages": stages, "final_lambda": lam,
            "mean_mutation_accept": float(torch.stack(accs).mean()),
            "host_syncs": syncs, "theta": thetas}
    return samples, info
