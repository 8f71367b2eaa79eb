"""The No-U-Turn Sampler, iterative and multinomial (counterpart of
``alan_tpu/nuts.py``).

The design is fixed-shape: every draw walks all ``2^max_depth - 1``
leapfrog steps, doubling ``max_depth`` times, and a chain freezes in place
once its trajectory turns or diverges.  So the trajectory is the same
unrolled program for every draw and every chain, and a whole draw is
captured as one CUDA graph on the card.  The U-turn test of a subtree is
iterative: even leaves are kept at slot ``ctz(leaf)`` of a
``(max_depth + 1, chain, D)`` store, and at odd leaf ``i`` each completed
subtree of size ``2^j`` (``j`` up to the trailing ones of ``i``) is checked
against its left end, leaf ``i + 1 - 2^j``.  The leaf indices are host
ints of the unrolled loop, so ``_ctz`` and ``_trailing_ones`` are too.

Each chain draws its own momentum, direction bits and leaf and merge
uniforms, from the generator or from ``noise=``.
"""
from __future__ import annotations

import math

import torch

from .mcmc import LogPost, _Noise, _chains, value_and_grad
from .utils import seeded_generator


def _ctz(i: int, cap: int) -> int:
    """Trailing zeros of ``i``, capped at ``cap`` (``ctz(0) = cap``)."""
    if i == 0:
        return cap
    c = 0
    while i % 2 == 0 and c < cap:
        i >>= 1
        c += 1
    return c


def _trailing_ones(i: int, cap: int) -> int:
    c = 0
    while i % 2 == 1 and c < cap:
        i >>= 1
        c += 1
    return c


def _turning(z_l, r_l, z_r, r_r, inv_mass):
    dz = z_r - z_l
    return ((dz * (inv_mass * r_l)).sum(dim=-1) < 0) | \
        ((dz * (inv_mass * r_r)).sum(dim=-1) < 0)


def _where(c, a, b):
    """``torch.where`` of a per-chain condition over (chain, ...) values."""
    return torch.where(c.reshape(c.shape + (1,) * (a.dim() - c.dim())), a, b)


class _Draw:
    """One NUTS draw of every chain at a step size and inverse mass."""

    def __init__(self, vg, max_depth, leaf_uniform, merge_uniform, direction):
        self.vg, self.MD = vg, max_depth
        self.leaf_uniform = leaf_uniform      # (leaf index) -> (chain,)
        self.merge_uniform = merge_uniform    # (depth) -> (chain,)
        self.direction = direction            # (depth) -> (chain,) of +-1

    def leapfrog(self, z, r, g, e, inv_mass):
        r = r + 0.5 * e * g
        z = z + e * inv_mass * r
        lp, g = self.vg(z)
        r = r + 0.5 * e * g
        return z, r, g, lp

    def subtree(self, z0, r0, g0, depth, e, inv_mass, H0, leaf0):
        """Leapfrog ``2^depth`` steps from (z0, r0); returns the endpoint,
        the multinomial proposal, the subtree's log-weight, its turning and
        diverging flags and the sum of its acceptance statistics."""
        MD = self.MD
        C = z0.shape[0]
        ck_z = z0.new_zeros((MD + 1,) + z0.shape)
        ck_r = z0.new_zeros((MD + 1,) + z0.shape)
        z, r, g, z_prop = z0, r0, g0, z0
        logw = torch.full((C,), -math.inf, dtype=z0.dtype, device=z0.device)
        turning = torch.zeros(C, dtype=torch.bool, device=z0.device)
        diverging = torch.zeros_like(turning)
        sum_acc = torch.zeros(C, dtype=z0.dtype, device=z0.device)
        for i in range(2 ** depth):
            u = self.leaf_uniform(leaf0 + i)
            z_n, r_n, g_n, lp_n = self.leapfrog(z, r, g, e, inv_mass)
            delta = lp_n - 0.5 * (inv_mass * r_n * r_n).sum(dim=-1) + H0
            delta = torch.where(torch.isnan(delta), torch.full_like(delta, -math.inf), delta)
            div_n = delta < -1000.0
            sum_acc = sum_acc + torch.clamp(torch.exp(delta), max=1.0)
            # multinomial proposal within the subtree
            new_logw = torch.logaddexp(logw, delta)
            take = torch.log(u) < (delta - new_logw)
            z_prop_n = _where(take, z_n, z_prop)
            # the iterative turning checks of the subtrees this leaf completes
            turn_here = torch.zeros_like(turning)
            if i % 2 == 1:
                for j in range(1, min(_trailing_ones(i, MD), MD) + 1):
                    slot = _ctz(i + 1 - (1 << j), MD)
                    turn_here = turn_here | _turning(ck_z[slot], ck_r[slot], z_n, r_n,
                                                     inv_mass)
            else:
                slot = _ctz(i, MD)
                ck_z[slot] = z_n
                ck_r[slot] = r_n
            stop = turning | diverging
            # freeze once stopped
            z = _where(stop, z, z_n)
            r = _where(stop, r, r_n)
            g = _where(stop, g, g_n)
            z_prop = _where(stop, z_prop, z_prop_n)
            logw = torch.where(stop, logw, new_logw)
            turning = turning | (~stop & turn_here)
            diverging = diverging | (~stop & div_n)
        return z, r, g, z_prop, logw, turning, diverging, sum_acc

    def __call__(self, z, r0, eps, inv_mass):
        lp0, g0 = self.vg(z)
        H0 = -lp0 + 0.5 * (inv_mass * r0 * r0).sum(dim=-1)
        C = z.shape[0]
        zl = zr = z
        rl = rr = r0
        gl = gr = g0
        z_prop = z
        logw = torch.zeros(C, dtype=z.dtype, device=z.device)
        done = torch.zeros(C, dtype=torch.bool, device=z.device)
        sum_acc = torch.zeros(C, dtype=z.dtype, device=z.device)
        n_acc = torch.zeros(C, dtype=z.dtype, device=z.device)
        leaf0 = 0
        for d in range(self.MD):
            direction = self.direction(d)
            fwd = direction > 0
            e = (eps * direction)[:, None]
            z0, r0_, g0_ = _where(fwd, zr, zl), _where(fwd, rr, rl), _where(fwd, gr, gl)
            z_e, r_e, g_e, z_p, lw, turning, diverging, s_acc = self.subtree(
                z0, r0_, g0_, d, e, inv_mass, H0, leaf0)
            leaf0 += 2 ** d
            ok = ~(turning | diverging) & ~done
            # the multinomial merge across subtrees
            total = torch.logaddexp(logw, lw)
            take = torch.log(self.merge_uniform(d)) < (lw - total)
            z_prop = _where(ok & take, z_p, z_prop)
            logw = torch.where(ok, total, logw)
            sum_acc = sum_acc + torch.where(done, torch.zeros_like(s_acc), s_acc)
            n_acc = n_acc + torch.where(done, 0.0, float(2 ** d))
            zl_n, rl_n, gl_n = _where(fwd, zl, z_e), _where(fwd, rl, r_e), _where(fwd, gl, g_e)
            zr_n, rr_n, gr_n = _where(fwd, z_e, zr), _where(fwd, r_e, rr), _where(fwd, g_e, gr)
            zl, rl, gl = _where(ok, zl_n, zl), _where(ok, rl_n, rl), _where(ok, gl_n, gl)
            zr, rr, gr = _where(ok, zr_n, zr), _where(ok, rr_n, rr), _where(ok, gr_n, gr)
            glob_turn = _turning(zl, rl, zr, rr, inv_mass)
            done = done | turning | diverging | glob_turn
        accept_stat = sum_acc / torch.clamp(n_acc, min=1.0)
        accept_stat = torch.where(torch.isnan(accept_stat),
                                  torch.zeros_like(accept_stat), accept_stat)
        return z_prop, accept_stat


def run_nuts(P, data, num_samples=1000, num_warmup=1000, num_chains=4,
             max_depth=8, target_accept=0.8, generator=None, latents=None,
             noise=None):
    """Adaptive NUTS.  Returns ``(samples, diagnostics)`` as ``run_hmc``.
    ``noise`` replaces the generator's draws: ``init`` (chain, D) and, with
    a leading axis of warmup + draws, ``momenta`` (chain, D) standard
    normals, ``directions`` (chain, max_depth) booleans (True forward),
    ``merge`` (chain, max_depth) and ``leaf`` (chain, 2^max_depth - 1)
    uniforms."""
    device = P.device
    if generator is None:
        generator = seeded_generator(0, device)
    logpost = LogPost(P, data, latents, generator if latents is None else None)
    vg = lambda th: value_and_grad(logpost, th)
    draws_of = _Noise(noise, device, logpost.dtype)
    D, C, MD = logpost.D, num_chains, max_depth
    theta_init = (logpost.theta0.to(device)[None, :]
                  + 0.1 * draws_of.initial((C, D), generator))

    def kernel(theta, eps, inv_mass, i, phase, gen):
        j = i if phase == "warmup" else i + num_warmup
        r0 = draws_of(torch.randn, "momenta", j, (C, D), gen) / torch.sqrt(inv_mass)
        if draws_of.noise is not None:
            bits = draws_of.noise["directions"].index_select(0, j.reshape(1))[0]
        else:
            bits = torch.rand((C, MD), generator=gen, device=device) < 0.5
        merge = draws_of(torch.rand, "merge", j, (C, MD), gen)
        leaf = draws_of(torch.rand, "leaf", j, (C, 2 ** MD - 1), gen)
        directions = torch.where(bits, 1.0, -1.0).to(theta.dtype)
        draw = _Draw(vg, MD, lambda k: leaf[:, k], lambda d: merge[:, d],
                     lambda d: directions[:, d])
        return draw(theta, r0, eps, inv_mass)

    draws, accs, eps, capture_s = _chains(theta_init, num_warmup, num_samples, kernel,
                                          target_accept, generator)
    diagnostics = {"mean_accept": float(accs.mean()), "step_size": float(eps),
                   "theta": draws, "capture_s": capture_s}
    return logpost.samples(draws), diagnostics
