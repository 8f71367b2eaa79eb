"""Operands for the lazy low-rank contraction, built with numpy from a seed
and shared by the CPU tests, the card tests and ``chip_smoke.py`` (which
puts this directory on its path).  Imports neither JAX nor torch."""
import numpy as np


def normal_factor_operands(shape, seed, offset, scale, spread):
    """(U, V, D, G) as ``ops/lowrank._normal_terms`` builds U and V for a
    Normal with d = F / 2 dims: samples y (P, I, d) and locations (J, d)
    around a random centre, the centre c0 the mean of y over (p, i).  Half
    the plates sit at +2 * offset, half at 0, so c0 lies at +offset; the
    locations at +1.5 * offset.  With a large offset / scale and a small
    spread the first half's scores cancel: yc ~ 2 (loc - c0) makes the two
    terms of each dim nearly equal and opposite."""
    S, P, I, J, F = shape
    d = F // 2
    rng = np.random.default_rng(seed)
    c = rng.standard_normal(d)
    lift = np.where(np.arange(P) % 2 == 0, 2 * offset, 0.0)[:, None, None]
    y = c + lift + spread * rng.standard_normal((P, I, d))
    loc = c + 1.5 * offset + spread * rng.standard_normal((J, d))
    sc = scale * np.exp(0.1 * rng.standard_normal((J, d)))
    c0 = y.reshape(-1, d).mean(0)
    yc, locc, inv = y - c0, loc - c0, 1.0 / sc ** 2
    U = np.concatenate([yc * yc, yc], -1)[None].astype(np.float32)
    V = np.concatenate([-0.5 * inv, locc * inv], -1)[None].astype(np.float32)
    D = rng.standard_normal((S, P, I)).astype(np.float32)
    G = rng.standard_normal((S, P, J)).astype(np.float32)
    return U, V, D, G
