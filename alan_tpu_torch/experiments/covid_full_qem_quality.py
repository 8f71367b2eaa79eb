"""Full-size covid QEM against the latents that generated its counts (the
port's counterpart of ``scripts/covid_full_qem_quality.py``).

    python -m alan_tpu_torch.experiments.covid_full_qem_quality [--device cpu]

Per seed (0, 1, 2; each draws its own dataset): covid at 92 regions x 137
days (109 training days) with :func:`covid_recipe.full_size_recipe`'s
counts, from a known driftless log-infected walk and a known psi.  QEM at
K = 30 with the delayed-averaging schedule ``"0.1/t@100"``, 12 segments of
50 steps through ``train.scan_steps`` (on the card one captured step,
replayed, the schedule's t advancing inside it), from a generator seeded
``seed + 100``.  After each segment: the last ELBO, the predictive
log-likelihood over all 137 days (``predict.predictive_ll_fn``, K = 30,
N = 50, FFBS rolled forward; a generator seeded ``fold_seed(seed + 200,
segment)``) and the largest relative drift of the QEM means.  At the end
the standardized residuals of the QEM moments against the generating
``log_infected`` and ``psi``, and across seeds the relative difference of
the moment vectors' norms.  The port adds each segment's ms a step and the
device's peak memory.  Writes ``covid_full_qem_quality.json``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..utils import resolve_device, seeded_generator
from . import covid_recipe as cr

K = 30
SEG = 50
N_SEGS = 12
LR = "0.1/t@100"
PRED_N = 50


def _flat(sQ):
    return np.concatenate([np.ravel(_numpy(v)) for _, v in sorted(sQ["qem_means"].items())])


def _numpy(v):
    v = getattr(v, "data", v)
    return v.detach().cpu().numpy()


def _unwrap(state):
    if len(state) == 2 and not isinstance(state[1], dict):
        state, _ = state                    # a schedule's ((sP, sQ), t)
    return state


def latent_recovery(means, truth):
    """Standardized residuals of the QEM moments (``{name}_mean``,
    ``{name}_mean2``) against the generating latents ``{name: (array,
    dims)}``, truth cut to the moments' plate sizes
    (``covid_full_qem_quality.py:136-166``)."""
    from ..dims import DT
    resid = {}
    for name, (arr, dims) in truth.items():
        mk, m2k = f"{name}_mean", f"{name}_mean2"
        if mk not in means or m2k not in means:
            continue
        m, m2 = means[mk], means[m2k]
        t = DT(torch.as_tensor(arr), tuple(dims))
        try:
            ta = t.with_dims_front(list(m.dims)).data.numpy()
        except Exception:
            continue
        ma, va = _numpy(m), _numpy(m2) - _numpy(m) ** 2
        if ta.shape != ma.shape:
            if all(ts >= ds for ts, ds in zip(ta.shape, ma.shape)):
                ta = ta[tuple(slice(0, d) for d in ma.shape)]
            else:
                continue
        z = (ma - ta) / np.sqrt(np.maximum(va, 1e-12))
        resid[name] = {"frac_within_5std": float(np.mean(np.abs(z) < 5)),
                       "z_median_abs": float(np.median(np.abs(z))), "n": int(z.size)}
    return resid


def run_seed(seed, device="cuda", nRs=None, nDs=None, K=K, seg=SEG, n_segs=N_SEGS,
             pred_N=PRED_N):
    from .. import train
    from ..predict import predictive_ll_fn
    from ..utils import fold_seed
    device = resolve_device(device)
    problem, all_ps, all_cov, all_data, truth = cr.full_size_recipe(seed, device, nRs, nDs)
    step, state = train.qem(problem, K, lr=LR, device=device)
    run = train.scan_steps(step, seg)
    pll_f = predictive_ll_fn(problem, K=K, N=pred_N, extended_platesizes=all_ps)
    gen = seeded_generator(seed + 100, device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    rec = {"segments": []}
    prev = flat = None
    for s in range(n_segs):
        cr.sync(device)
        t0 = time.perf_counter()
        state, elbos = run(state, gen)
        cr.sync(device)
        seconds = time.perf_counter() - t0
        capture = getattr(run, "capture_seconds", 0.0) or 0.0
        sP, sQ = _unwrap(state)
        flat = _flat(sQ)
        drift = (float(np.max(np.abs(flat - prev) / np.maximum(np.abs(prev), 1e-3)))
                 if prev is not None else None)
        prev = flat
        t1 = time.perf_counter()
        pll = pll_f(sP, sQ, all_cov, all_data,
                    seeded_generator(fold_seed(seed + 200, s), device))
        pll_total = float(sum(float(v) for v in pll.values()))
        cr.sync(device)
        rec["segments"].append({
            "iters": (s + 1) * seg, "elbo": float(elbos[-1]), "predictive_ll": pll_total,
            "moment_max_rel_drift": drift,
            "elbos_finite": bool(torch.isfinite(elbos).all()),
            "ms_per_step": (seconds - (capture if s == 0 else 0.0)) / seg * 1e3,
            "capture_s": capture if s == 0 else 0.0,
            "predictive_ll_s": time.perf_counter() - t1})
        print(f"seed {seed} seg {s}: {rec['segments'][-1]}", flush=True)
    sP, sQ = _unwrap(state)
    resid = latent_recovery(sQ["qem_means"], truth)
    rec["latent_recovery"] = resid
    alln = [v["n"] for v in resid.values()]
    rec["latent_recovery_overall_frac_within_5std"] = (
        float(sum(v["frac_within_5std"] * v["n"] for v in resid.values()) / sum(alln))
        if alln else None)
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None
    rec["final_flat_means"] = flat.tolist()
    return rec


def interpretation(out, seeds):
    """The record's reading, seed by seed, in words."""
    parts = []
    for seed in seeds:
        rec = out[f"seed{seed}"]
        first, last = rec["segments"][0], rec["segments"][-1]
        parts.append(
            f"seed {seed}: ELBO {first['elbo']:.6g} -> {last['elbo']:.6g} "
            f"({'rising' if last['elbo'] > first['elbo'] else 'not rising'}), predictive LL "
            f"{first['predictive_ll']:.6g} -> {last['predictive_ll']:.6g}, "
            f"{rec['latent_recovery_overall_frac_within_5std']} of the generating latents "
            f"within 5 posterior sd")
    return "; ".join(parts)


def run(seeds=(0, 1, 2), device="cuda", nRs=None, nDs=None, K=K, seg=SEG, n_segs=N_SEGS,
        pred_N=PRED_N, out_dir=cr.RESULTS):
    from ..models import covid
    device = resolve_device(device)
    nR, nD = nRs or covid.nRs, nDs or covid.nDs
    out = {"model": f"covid full {nR}x{int(0.8 * nD)} (realistic synthetic counts + known "
                    f"generating log_infected/psi; {cr.DATA_NOTE})",
           "K": K, "lr": LR, "iters_total": seg * n_segs, "predictive_N": pred_N,
           "device": cr.card(device)}
    flats = {}
    for seed in seeds:
        rec = run_seed(seed, device, nRs, nDs, K, seg, n_segs, pred_N)
        flats[seed] = np.asarray(rec.pop("final_flat_means"))
        out[f"seed{seed}"] = rec
    if len(flats) >= 2:
        # each seed draws its own dataset: only the moment vectors' scales compare
        a, b = (flats[s] for s in list(flats)[:2])
        out["cross_seed_norm_rel_diff"] = float(np.linalg.norm(a - b)
                                                / max(np.linalg.norm(a), 1e-9))
    out["interpretation"] = interpretation(out, seeds)
    cr.write_json(cr.record_path(out_dir, "covid_full_qem_quality.json"), out)
    return out


def main(argv=None):
    ap = cr.parser(__doc__)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--nRs", type=int, default=None, help="regions (default 92)")
    ap.add_argument("--nDs", type=int, default=None, help="days in all (default 137)")
    ap.add_argument("--K", type=int, default=K)
    ap.add_argument("--seg", type=int, default=SEG, help="steps a segment")
    ap.add_argument("--segments", type=int, default=N_SEGS)
    ap.add_argument("--N", type=int, default=PRED_N, help="importance samples of the "
                    "predictive log-likelihood")
    a = ap.parse_args(argv)
    r = run(tuple(a.seeds), a.device, a.nRs, a.nDs, a.K, a.seg, a.segments, a.N, a.out_dir)
    print("->", cr.record_path(a.out_dir, "covid_full_qem_quality.json"))
    return r


if __name__ == "__main__":
    main()
