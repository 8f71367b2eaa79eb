"""Gradient MCMC on the model IR (counterpart of ``alan_tpu/mcmc.py``).

The P program's log joint with no K-dims (``log_joint``), automatic
unconstraining from the distribution supports (``make_logpost``), and an
adaptive HMC (``run_hmc``): dual-averaging step size and a diagonal mass
from the warmup's variance.

The chains are a leading batch axis, not a ``vmap``: every latent carries a
``chain`` dim, each factor is summed over every dim but ``chain``, and the
log posterior of a ``(chain, D)`` batch of unconstrained vectors is one
``(chain,)`` tensor, whose sum's gradient is every chain's gradient (the
chains are independent).  Theta is laid out as ``jax.flatten_util.
ravel_pytree`` lays out ``alan_tpu``'s: the latents' names in sorted order,
each in C order over its dims (those of the starting latents) and event
axes, so a theta vector means the same in both packages.

A sampler takes its device from the ``BoundPlate``, its draws from a
``torch.Generator`` on that device or from injected standard noise
(``noise=``, the tests' route to ``alan_tpu``'s draws), and its starting
latents from a prior draw of that generator or from ``latents=``.  On the
card each iteration of a loop is captured as a CUDA graph and replayed
(``train.scan_steps``: its counter, its draws, the iteration index on the
card), bitwise the eager loop; on the CPU the loop runs eagerly.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .bound import BoundPlate
from .dims import DT, as_dt, bind, expand_to, sum_pos
from .ir.plate import Plate
from .ir.dist import Dist
from .ir.timeseries import Timeseries
from .utils import seeded_generator

CHAIN = "chain"


# -- log joint over the P program (no K dims) ------------------------------

def _ts_log_prob_chain(ts: Timeseries, sample, scope: dict, T_dim: str):
    """A timeseries' log-probability without particle dims: step t given
    the sample's step t - 1, step 0 given ``ts.init``."""
    o = as_dt(sample).order(T_dim)                  # (rem..., T, pos...)
    ax = len(o.dims)
    body = o.data.narrow(ax, 0, o.data.shape[ax] - 1)
    init = expand_to(as_dt(scope[ts.init]), o.dims).unsqueeze(ax)
    init = torch.broadcast_to(init, body.shape[:ax] + (1,) + body.shape[ax + 1:])
    lagged = bind(DT(torch.cat([init, body], dim=ax), o.dims), T_dim)
    return ts.trans.log_prob(sample, {**scope, "prev": lagged})


def _scalar(lp):
    """A factor summed over every dim and axis but ``chain``: a ``(chain,)``
    tensor, or 0-d where the factor has no chain dim."""
    lp = sum_pos(as_dt(lp))
    if not isinstance(lp, DT):
        return torch.as_tensor(lp)
    keep = (CHAIN,) if CHAIN in lp.dims else ()
    o = lp.order(*keep)
    return o.data.sum(dim=tuple(range(len(o.dims)))) if o.dims else o.data


def _walk(P: BoundPlate, latents: dict, data: dict, add, state=None):
    """Walk the P program; ``add(kind, lp)`` takes each factor, ``kind``
    ``"prior"`` for a latent and ``"lik"`` for a data variable."""
    def walk(plate: Plate, scope: dict, active: list):
        for name, node in plate.flat_prog.items():
            if isinstance(node, Plate):
                walk(node, dict(scope), active + [name])
            elif isinstance(node, Timeseries):
                x = latents[name]
                add("prior", _scalar(_ts_log_prob_chain(node, x, scope, active[-1])))
                scope[name] = x
            else:
                assert isinstance(node, Dist)
                if name in data:
                    add("lik", _scalar(node.log_prob(data[name], scope)))
                else:
                    x = latents[name]
                    add("prior", _scalar(node.log_prob(x, scope)))
                    scope[name] = x
    walk(P.plate, dict(P.inputs_params_flat_named(state)), [])


def log_joint(P: BoundPlate, latents: dict, data: dict, state=None):
    """log p(latents, data) under the P program, per chain.  ``latents`` and
    ``data`` are flat dicts of dimmed tensors (plate dims named; a ``chain``
    dim on the latents batches chains)."""
    total = [0.0]

    def add(kind, lp):
        total[0] = total[0] + lp
    _walk(P, latents, data, add, state)
    return torch.as_tensor(total[0])


# -- automatic unconstraining ---------------------------------------------
#
# Every transform takes ``u`` with a leading chain axis and returns the
# constrained value and log|det J| per chain.

_TRANSFORMS = {
    "real": "id", "real_vector": "id", "circular": "id",
    "positive": "exp",
    "unit_interval": "sigmoid",
    "simplex": "stickbreak",
    "corr_cholesky": "corrchol",
}


def _per_chain(x):
    return x.reshape(x.shape[0], -1).sum(dim=1)


def _constrain(kind, u):
    if kind == "id":
        return u, torch.zeros(u.shape[:1], dtype=u.dtype, device=u.device)
    if kind == "exp":
        return torch.exp(u), _per_chain(u)
    if kind == "sigmoid":
        return torch.sigmoid(u), _per_chain(F.logsigmoid(u) + F.logsigmoid(-u))
    if kind == "stickbreak":
        return _stickbreak_fwd(u)
    if kind == "corrchol":
        return _corrchol_fwd(u)
    raise ValueError(kind)


def _offsets(dm1, like):
    return -torch.log(torch.arange(dm1, 0, -1, dtype=like.dtype, device=like.device))


def _stickbreak_fwd(u):
    """Logistic stick-breaking: u (..., d-1) -> simplex x (..., d), with the
    Stan-style offset so that u = 0 maps to the uniform simplex point."""
    dm1 = u.shape[-1]
    y = u + _offsets(dm1, u)
    z = torch.sigmoid(y)
    r = torch.ones(u.shape[:-1], dtype=u.dtype, device=u.device)
    xs, lds = [], []
    for k in range(dm1):
        xs.append(z[..., k] * r)
        lds.append(F.logsigmoid(y[..., k]) + F.logsigmoid(-y[..., k]) + torch.log(r))
        r = r * (1.0 - z[..., k])
    x = torch.stack(xs + [r], dim=-1)
    return x, _per_chain(torch.stack(lds, dim=-1))


def _corrchol_fwd(u):
    """Canonical-partial-correlation transform (Stan reference manual,
    cholesky_corr): u (..., d(d-1)/2) -> the lower-triangular Cholesky
    factor of a correlation matrix (..., d, d), with log|det J|."""
    m = u.shape[-1]
    d = int((1 + (1 + 8 * m) ** 0.5) / 2)
    z = torch.tanh(u)
    batch = u.shape[:-1]
    zero = torch.zeros(batch, dtype=u.dtype, device=u.device)
    one = torch.ones(batch, dtype=u.dtype, device=u.device)
    logdet = _per_chain(torch.log1p(-z * z))        # d tanh / du = 1 - z^2
    rows = [[one] + [zero] * (d - 1)]
    idx = 0
    for i in range(1, d):
        rem = one                                   # remaining squared norm
        row = []
        for j in range(i):
            row.append(z[..., idx] * torch.sqrt(rem))
            # dx_ij / dz_ij = sqrt(rem): the triangular Jacobian's entry
            logdet = logdet + 0.5 * _per_chain(torch.log(rem))
            rem = rem * (1.0 - z[..., idx] ** 2)
            idx += 1
        row.append(torch.sqrt(torch.clamp(rem, min=1e-12)))
        rows.append(row + [zero] * (d - 1 - i))
    L = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    return L, logdet


def _corrchol_inv(L):
    """Inverse of ``_corrchol_fwd``."""
    d = L.shape[-1]
    batch = L.shape[:-2]
    us = []
    for i in range(1, d):
        rem = torch.ones(batch, dtype=L.dtype, device=L.device)
        for j in range(i):
            z = torch.clamp(L[..., i, j] / torch.sqrt(torch.clamp(rem, min=1e-12)),
                            -1 + 1e-6, 1 - 1e-6)
            us.append(torch.atanh(z))
            rem = rem * (1.0 - z ** 2)
    if not us:
        return torch.zeros(batch + (0,), dtype=L.dtype, device=L.device)
    return torch.stack(us, dim=-1)


def _stickbreak_inv(x):
    """Inverse stick-breaking: simplex x (..., d) -> u (..., d-1)."""
    x = torch.clamp(x, 1e-6, 1.0)
    dm1 = x.shape[-1] - 1
    cum = torch.cumsum(x[..., :-1], dim=-1)
    if dm1 > 1:
        r = torch.cat([torch.ones_like(x[..., :1]), 1.0 - cum[..., :-1]], dim=-1)
    else:
        r = torch.ones_like(x[..., :1])
    r = torch.clamp(r, 1e-6, 1.0)
    z = torch.clamp(x[..., :-1] / r, 1e-6, 1 - 1e-6)
    return torch.log(z) - torch.log1p(-z) - _offsets(dm1, x)


def _unconstrain(kind, x):
    if kind == "exp":
        return torch.log(torch.clamp(x, min=1e-6))
    if kind == "sigmoid":
        p = torch.clamp(x, 1e-6, 1 - 1e-6)
        return torch.log(p) - torch.log1p(-p)
    if kind == "stickbreak":
        return _stickbreak_inv(x)
    if kind == "corrchol":
        return _corrchol_inv(x)
    return x


def _latent_specs(P: BoundPlate, data: dict):
    """(varname, plates, transform) of each variable that is not observed."""
    specs = []

    def walk(plate, active):
        for name, node in plate.flat_prog.items():
            if isinstance(node, Plate):
                walk(node, active + [name])
                continue
            if name in data:
                continue
            fam = node.trans.family if isinstance(node, Timeseries) else node.family
            if fam.discrete:
                raise ValueError(
                    f"{name} is discrete ({fam.name}); HMC needs continuous "
                    f"latents: marginalise it or use SMC/MP inference")
            if fam.support not in _TRANSFORMS:
                raise ValueError(f"no unconstraining transform for support "
                                 f"{fam.support!r} ({name})")
            specs.append((name, tuple(active), _TRANSFORMS[fam.support]))
    walk(P.plate, [])
    return specs


class LogPost:
    """The log posterior on one flat unconstrained vector per chain:
    ``logpost(theta)`` with theta ``(chain, D)`` gives ``(chain,)``.
    ``theta0`` (D,) is the starting latents unconstrained; ``unravel`` and
    ``constrain`` read a theta batch."""

    def __init__(self, P: BoundPlate, data: dict, latents=None, generator=None):
        self.P = P
        self.data = {k: as_dt(v) for k, v in data.items()}
        # theta is float64 where the data is, else float32
        self.dtype = (torch.float64 if any(v.data.dtype == torch.float64
                                           for v in self.data.values())
                      else torch.float32)
        specs = _latent_specs(P, self.data)
        self.trans = {name: tr for name, _, tr in specs}
        if latents is None:
            if generator is None:
                generator = seeded_generator(0, P.device)
            latents = P.sample(generator)
        latents = {k: as_dt(v) for k, v in latents.items() if k not in self.data}
        if set(latents) != set(self.trans):
            raise ValueError(f"starting latents {sorted(latents)} are not the "
                             f"latents {sorted(self.trans)}")
        self.layout = []          # (name, dims, positional shape, offset, size)
        parts, off = [], 0
        for name in sorted(latents):
            v = latents[name]
            u = _unconstrain(self.trans[name], v.data.to(P.device))
            self.layout.append((name, v.dims, tuple(u.shape), off, u.numel()))
            parts.append(u.reshape(-1))
            off += u.numel()
        self.theta0 = torch.cat(parts).to(self.dtype)
        self.D = off

    def unravel(self, theta):
        """{name: (chain, *shape)} of a (chain, D) batch."""
        return {name: theta[:, off:off + n].reshape((theta.shape[0],) + shape)
                for name, _, shape, off, n in self.layout}

    def constrain(self, theta):
        """(latents with a chain dim, log|det J| per chain)."""
        out, logdet = {}, 0.0
        for name, dims, shape, off, n in self.layout:
            u = theta[:, off:off + n].reshape((theta.shape[0],) + shape)
            x, ld = _constrain(self.trans[name], u)
            out[name] = DT(x, (CHAIN,) + dims)
            logdet = logdet + ld
        return out, logdet

    def __call__(self, theta):
        latents, logdet = self.constrain(theta)
        return log_joint(self.P, latents, self.data) + logdet

    def samples(self, thetas, lead=("draw", CHAIN)):
        """The constrained draws of a (*lead, D) batch, each a DT with the
        ``lead`` dims in front of its plates."""
        flat = thetas.reshape(-1, thetas.shape[-1])
        out = {}
        for name, dims, shape, off, n in self.layout:
            u = flat[:, off:off + n].reshape((flat.shape[0],) + shape)
            x, _ = _constrain(self.trans[name], u)
            out[name] = DT(x.reshape(tuple(thetas.shape[:-1]) + tuple(x.shape[1:])),
                           tuple(lead) + dims)
        return out


def make_logpost(P: BoundPlate, data: dict, latents=None, generator=None):
    """``(logpost, theta0, unravel, constrain)`` as ``alan_tpu``'s, on a
    ``(chain, D)`` batch; ``latents`` (a flat dict of dimmed tensors, such
    as a prior draw) or a prior draw from ``generator`` is the start."""
    lp = LogPost(P, data, latents, generator)
    return lp, lp.theta0, lp.unravel, lp.constrain


def value_and_grad(logpost, theta):
    """(logpost(theta), its gradient) of a (chain, D) batch, detached: one
    backward pass of the sum over chains."""
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        lp = logpost(th)
        g, = torch.autograd.grad(lp.sum(), th)
    return lp.detach(), g


# -- randomness -------------------------------------------------------------

class _Noise:
    """The draws of a sampler, in theta's ``dtype``: from ``generator``, or
    from ``noise`` (a dict of tensors, each with a leading iteration axis,
    indexed at the loop's counter on the device)."""

    def __init__(self, noise, device, dtype):
        self.noise = None if noise is None else {
            k: torch.as_tensor(np.array(v)).to(device) for k, v in noise.items()}
        self.device, self.dtype = device, dtype

    def __call__(self, draw, key, i, shape, generator):
        """Iteration ``i``'s ``noise[key]``, or ``draw`` (``torch.randn`` or
        ``torch.rand``) of ``shape`` from ``generator``."""
        if self.noise is not None:
            return self.noise[key].index_select(0, i.reshape(1))[0].to(self.dtype)
        return draw(shape, generator=generator, dtype=self.dtype, device=self.device)

    def initial(self, shape, generator):
        if self.noise is not None:
            return self.noise["init"].to(self.dtype)
        return torch.randn(shape, generator=generator, dtype=self.dtype,
                           device=self.device)


def _loop(step, n, state, generator):
    """``n`` iterations of ``step(state, generator) -> (state, stat)``: on
    the card one iteration captured as a CUDA graph and replayed
    (``train.scan_steps``), on the CPU the eager loop.  Returns (state,
    stats, seconds spent capturing)."""
    from .train import scan_steps
    if n == 0:
        return state, torch.zeros(0), 0.0
    run = scan_steps(step, n)
    state, stats = run(state, generator)
    return state, stats, run.capture_seconds


class _DualAveraging:
    """Hoffman and Gelman's dual averaging of the step size, and the
    batched Welford variance of every chain's position (Chan et al.), both
    indexed by the warmup iteration ``i``, a 0-d int64 tensor on the card
    (a captured iteration reads it there; a host int would be frozen at
    capture)."""

    def __init__(self, target_accept):
        self.target = target_accept
        self.mu = math.log(10 * 0.1)

    def initial(self, D, device, dtype):
        z = lambda: torch.zeros((), dtype=torch.float32, device=device)
        log01 = torch.full((), math.log(0.1), dtype=torch.float32, device=device)
        return (log01, log01.clone(), z(), z(),
                torch.zeros(D, dtype=dtype, device=device),
                torch.zeros(D, dtype=dtype, device=device))

    def update(self, i, adapt, p_acc, theta):
        log_eps, log_eps_bar, h_bar, n, mean_, m2 = adapt
        fi = i.to(torch.float32)
        a = p_acc.mean()
        t_ = fi + 1.0 + 10.0
        h_bar = (1 - 1 / t_) * h_bar + (self.target - a) / t_
        log_eps = self.mu - torch.sqrt(fi + 1.0) / 0.05 * h_bar
        w = (fi + 1.0) ** -0.75
        log_eps_bar = w * log_eps + (1 - w) * log_eps_bar
        m_obs = theta.shape[0]
        bmean = theta.mean(dim=0)
        bm2 = ((theta - bmean) ** 2).sum(dim=0)
        n1 = n + m_obs
        delta = bmean - mean_
        mean_ = mean_ + delta * (m_obs / n1)
        m2 = m2 + bm2 + delta ** 2 * (n * m_obs / n1)
        return (log_eps, log_eps_bar, h_bar, n1, mean_, m2)

    @staticmethod
    def adapted(adapt):
        """(step size, inverse mass) after the warmup."""
        _, log_eps_bar, _, n, _, m2 = adapt
        return (torch.exp(log_eps_bar),
                torch.clamp(m2 / torch.clamp(n - 1, min=1.0), 1e-4, 1e4))


def _stat(p_acc):
    """An iteration's mean acceptance, in float32 as ``scan_steps`` keeps its
    per-step values."""
    return p_acc.mean().to(torch.float32)


def _chains(theta_init, num_warmup, num_samples, kernel, target_accept, generator):
    """Warmup (dual averaging, Welford) and sampling loops of a one-draw
    ``kernel(theta, eps, inv_mass, i, phase, generator) -> (theta, p_acc)``
    over a (chain, D) batch; returns ((draw, chain, D) draws, mean
    acceptance per draw, step size, seconds spent capturing)."""
    device = theta_init.device
    C, D = theta_init.shape
    da = _DualAveraging(target_accept)
    ones = torch.ones(D, dtype=theta_init.dtype, device=device)

    def warm(state, gen):
        theta, i, adapt = state
        theta, p_acc = kernel(theta, torch.exp(adapt[0]), ones, i, "warmup", gen)
        return (theta, i + 1, da.update(i, adapt, p_acc, theta)), _stat(p_acc)

    i0 = torch.zeros((), dtype=torch.int64, device=device)
    (theta, _, adapt), _, capture_warm = _loop(
        warm, num_warmup, (theta_init, i0, da.initial(D, device, theta_init.dtype)),
        generator)
    eps, inv_mass = da.adapted(adapt)
    draws = torch.empty((num_samples, C, D), dtype=theta_init.dtype, device=device)

    def sample(state, gen):
        theta, i = state
        theta, p_acc = kernel(theta, eps, inv_mass, i, "sample", gen)
        draws.index_copy_(0, i.reshape(1), theta[None])
        return (theta, i + 1), _stat(p_acc)

    _, accs, capture_sample = _loop(sample, num_samples, (theta, i0.clone()), generator)
    return draws, accs, eps, capture_warm + capture_sample


# -- HMC --------------------------------------------------------------------

def _leapfrog(vg, theta, m, g, eps, inv_mass, n_steps):
    """``n_steps`` leapfrog steps from (theta, m) with the gradient ``g`` at
    theta; returns (theta, m, logpost, gradient) at the end."""
    lp = None
    for _ in range(n_steps):
        m = m + 0.5 * eps * g
        theta = theta + eps * inv_mass * m
        lp, g = vg(theta)
        m = m + 0.5 * eps * g
    return theta, m, lp, g


def run_hmc(P: BoundPlate, data: dict, num_samples=1000, num_warmup=1000,
            num_chains=4, num_leapfrog=16, target_accept=0.8, generator=None,
            latents=None, noise=None):
    """Adaptive HMC.  Returns ``(samples, diagnostics)``: each latent a DT
    with ``draw`` and ``chain`` dims in front of its plates, and the mean
    acceptance and adapted step size.  The chains run in float64 where the
    data is float64, else in float32.  ``noise`` replaces the generator's
    draws: ``init`` (chain, D), ``momenta`` (warmup + draws, chain, D) and
    ``uniforms`` (warmup + draws, chain), standard normals and uniforms."""
    device = P.device
    if generator is None:
        generator = seeded_generator(0, device)
    logpost = LogPost(P, data, latents, generator if latents is None else None)
    vg = lambda th: value_and_grad(logpost, th)
    draws_of = _Noise(noise, device, logpost.dtype)
    D = logpost.D
    theta_init = (logpost.theta0.to(device)[None, :]
                  + 0.1 * draws_of.initial((num_chains, D), generator))

    def kernel(theta, eps, inv_mass, i, phase, gen):
        j = i if phase == "warmup" else i + num_warmup
        m = draws_of(torch.randn, "momenta", j, theta.shape, gen) / torch.sqrt(inv_mass)
        u = draws_of(torch.rand, "uniforms", j, theta.shape[:1], gen)
        lp0, g0 = vg(theta)
        ke0 = 0.5 * (inv_mass * m * m).sum(dim=1)
        theta_new, m_new, lp1, _ = _leapfrog(vg, theta, m, g0, eps, inv_mass,
                                             num_leapfrog)
        ke1 = 0.5 * (inv_mass * m_new * m_new).sum(dim=1)
        log_accept = torch.clamp((lp1 - ke1) - (lp0 - ke0), max=0.0)
        log_accept = torch.where(torch.isnan(log_accept),
                                 torch.full_like(log_accept, -math.inf), log_accept)
        accept = torch.log(u) < log_accept
        return torch.where(accept[:, None], theta_new, theta), torch.exp(log_accept)

    draws, accs, eps, capture_s = _chains(theta_init, num_warmup, num_samples, kernel,
                                          target_accept, generator)
    diagnostics = {"mean_accept": float(accs.mean()), "step_size": float(eps),
                   "theta": draws, "capture_s": capture_s}
    return logpost.samples(draws), diagnostics
