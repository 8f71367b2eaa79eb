"""The conditional FFBS pass's error as two chains couple (the port's
counterpart of ``scripts/ffbs_coupling_sweep.py``).

    python -m alan_tpu_torch.experiments.ffbs_coupling_sweep [--device cpu]

Two AR(1) chains (A = 0.9 and 0.5, noise 0.4, T = 6) observed through
obs = ts1 + c * ts2 (noise 1) for c in {0.1, 0.25, 0.5, 0.75, 1.0}.  The
analytic Kalman posterior means of both chains (:func:`build`) are held
against importance-sample means (K = 16 particles, N = 4000 draws, 8
repetitions) by the exact joint smoother and by the linear-cost
conditional pass, chosen as the JAX script chooses them: by setting
``ALAN_TPU_FFBS_JOINT_MAX`` to 100000 or 1 for the call (the port reads it
at every call).  Repetition r draws its particles from a generator seeded
``fold_seed(key0, r)`` and its importance samples from one seeded
``fold_seed(fold_seed(key0, r), 999)``.  Writes
``ffbs_coupling_sweep.json``.
"""
from __future__ import annotations

import os

import numpy as np

from ..utils import resolve_device, seeded_generator
from . import covid_recipe as cr

T = 6
A1, A2 = 0.9, 0.5
init_scale = 1.0
ts_noise_scale = 0.4
obs_noise_scale = 1.0
COUPLINGS = (0.1, 0.25, 0.5, 0.75, 1.0)


def _ar1_cov(A):
    cov = np.zeros((T, T))
    diag_var = init_scale ** 2
    for i in range(T):
        diag_var = diag_var * A ** 2 + ts_noise_scale ** 2
        future = diag_var * A ** np.arange(T - i)
        cov[i, i:] = future
        cov[i:, i] = future
    return cov


def kalman_posterior(c, seed=21):
    """(observations, analytic posterior means of ts1 and ts2) at coupling
    ``c``: y drawn from the model's marginal by ``numpy`` seed ``seed``."""
    C1, C2 = _ar1_cov(A1), _ar1_cov(A2)
    S = C1 + c * c * C2 + obs_noise_scale ** 2 * np.eye(T)
    rng = np.random.default_rng(seed)
    y = np.linalg.cholesky(S) @ rng.standard_normal(T)
    Sinv_y = np.linalg.solve(S, y)
    return y, C1 @ Sinv_y, c * (C2 @ Sinv_y)


def build(c, seed=21, device="cuda"):
    """(problem, analytic posterior means of ts1 and ts2) at coupling c."""
    from .. import BoundPlate, Data, Normal, Plate, Problem, Timeseries
    from ..convert import dt_from_numpy
    P = Plate(
        init1=Normal(0, init_scale),
        init2=Normal(0, init_scale),
        T=Plate(
            ts1=Timeseries("init1", Normal(lambda prev: A1 * prev, ts_noise_scale)),
            ts2=Timeseries("init2", Normal(lambda prev: A2 * prev, ts_noise_scale)),
            obs=Normal(lambda ts1, ts2: ts1 + c * ts2, obs_noise_scale),
        ),
    )
    Q = Plate(
        init1=Normal(0, 1), init2=Normal(0, 1),
        T=Plate(ts1=Normal(0, 1), ts2=Normal(0, 1), obs=Data()),
    )
    y, post1, post2 = kalman_posterior(c, seed)
    ps = {"T": T}
    problem = Problem(BoundPlate(P, ps, device=device), BoundPlate(Q, ps, device=device),
                      {"obs": dt_from_numpy(y.astype(np.float32), ("T",), device)},
                      device=device)
    return problem, post1, post2


def estimate(problem, route_joint, K=16, N=4000, reps=8, key0=0):
    """Mean importance-sample estimates of (ts1, ts2) over ``reps``
    repetitions and their standard errors; ``route_joint`` forces the exact
    joint smoother (cap high) or the conditional pass (cap 1)."""
    from ..moments import mean
    from ..utils import fold_seed
    device = problem.device
    old = os.environ.get("ALAN_TPU_FFBS_JOINT_MAX")
    os.environ["ALAN_TPU_FFBS_JOINT_MAX"] = "100000" if route_joint else "1"
    try:
        ests = []
        for r in range(reps):
            k = fold_seed(key0, r)
            s = problem.sample(K, seeded_generator(k, device), reparam=False)
            isamp = s.importance_sample(N, seeded_generator(fold_seed(k, 999), device))
            e = [isamp.moments(v, mean).data.detach().cpu().numpy() for v in ("ts1", "ts2")]
            ests.append(np.stack(e).astype(np.float64))
        ests = np.stack(ests)                     # (reps, 2, T)
    finally:
        if old is None:
            del os.environ["ALAN_TPU_FFBS_JOINT_MAX"]
        else:
            os.environ["ALAN_TPU_FFBS_JOINT_MAX"] = old
    return ests.mean(0), ests.std(0, ddof=1) / np.sqrt(ests.shape[0])


def bias_record(est, se, truth):
    bias = est - truth
    return {"max_abs_bias": float(np.max(np.abs(bias))),
            "mean_abs_bias": float(np.mean(np.abs(bias))),
            "max_stderr": float(np.max(se)),
            "max_bias_over_stderr": float(np.max(np.abs(bias) / np.maximum(se, 1e-9)))}


def run(couplings=COUPLINGS, K=16, N=4000, reps=8, device="cuda", out_dir=cr.RESULTS):
    import time
    device = resolve_device(device)
    out = {"T": T, "A1": A1, "A2": A2, "K": K, "N": N, "reps": reps, "couplings": {},
           "device": cr.card(device)}
    for c in couplings:
        problem, post1, post2 = build(c, device=device)
        truth = np.stack([post1, post2])
        res = {}
        for tag, joint in (("joint", True), ("conditional", False)):
            t0 = time.perf_counter()
            est, se = estimate(problem, joint, K, N, reps)
            res[tag] = dict(bias_record(est, se, truth), seconds=time.perf_counter() - t0)
        out["couplings"][str(c)] = res
        print(f"c={c}: joint bias {res['joint']['max_abs_bias']:.4f} "
              f"(z={res['joint']['max_bias_over_stderr']:.1f}), "
              f"conditional bias {res['conditional']['max_abs_bias']:.4f} "
              f"(z={res['conditional']['max_bias_over_stderr']:.1f})", flush=True)
    cr.write_json(cr.record_path(out_dir, "ffbs_coupling_sweep.json"), out)
    return out


def main(argv=None):
    ap = cr.parser(__doc__)
    ap.add_argument("--couplings", type=float, nargs="+", default=list(COUPLINGS))
    ap.add_argument("--K", type=int, default=16)
    ap.add_argument("--N", type=int, default=4000)
    ap.add_argument("--reps", type=int, default=8)
    a = ap.parse_args(argv)
    r = run(tuple(a.couplings), a.K, a.N, a.reps, a.device, a.out_dir)
    print("->", cr.record_path(a.out_dir, "ffbs_coupling_sweep.json"))
    return r


if __name__ == "__main__":
    main()
