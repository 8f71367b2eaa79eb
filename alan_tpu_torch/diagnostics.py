"""MCMC diagnostics (counterpart of ``alan_tpu/diagnostics.py``, the
port's own numpy copy): split-R-hat and bulk ESS of ``run_hmc`` /
``run_nuts`` draws, a ``DT`` with ``draw`` and ``chain`` dims (or an array
laid out (draw, chain, ...))."""
from __future__ import annotations

import numpy as np
import torch

from .dims import DT


def _draws(x) -> np.ndarray:
    if isinstance(x, DT):
        if x.dims[:2] != ("draw", "chain"):
            x = x.with_dims_front(("draw", "chain"))
        x = x.data
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def split_rhat(x) -> np.ndarray:
    """Gelman-Rubin split-R-hat per parameter component."""
    a = _draws(x)
    half = a.shape[0] // 2
    a = np.concatenate([a[:half], a[half:2 * half]], axis=1)  # (half, 2m, ...)
    n = a.shape[0]
    chain_mean = a.mean(axis=0)
    chain_var = a.var(axis=0, ddof=1)
    W = chain_var.mean(axis=0)
    B = n * chain_mean.var(axis=0, ddof=1)
    var_plus = (n - 1) / n * W + B / n
    return np.sqrt(var_plus / np.maximum(W, 1e-12))


def ess_bulk(x, max_lag: int = 200) -> np.ndarray:
    """Effective sample size by Geyer's initial positive sequence of
    autocorrelation pair sums, the chains pooled."""
    a = _draws(x)
    n, m = a.shape[0], a.shape[1]
    a = a - a.mean(axis=0, keepdims=True)
    flat = a.reshape(n, m, -1)
    ess = np.empty(flat.shape[2])
    for j in range(flat.shape[2]):
        var = (flat[:, :, j] ** 2).mean()
        if var < 1e-12:
            ess[j] = n * m
            continue
        rhos = [(flat[:-lag, :, j] * flat[lag:, :, j]).mean() / var
                for lag in range(1, min(max_lag, n - 1))]
        tau = 1.0
        for k in range(0, len(rhos) - 1, 2):
            pair = rhos[k] + rhos[k + 1]
            if pair < 0:
                break
            tau += 2 * pair
        ess[j] = n * m / tau
    return ess.reshape(a.shape[2:]) if a.ndim > 2 else ess.reshape(())


def summary(samples: dict) -> dict:
    """Per variable: mean, sd, the largest R-hat and the smallest ESS."""
    out = {}
    for name, x in samples.items():
        a = _draws(x)
        out[name] = {
            "mean": a.mean(axis=(0, 1)),
            "sd": a.std(axis=(0, 1)),
            "rhat_max": float(np.max(split_rhat(a))),
            "ess_min": float(np.min(ess_bulk(a))),
        }
    return out
