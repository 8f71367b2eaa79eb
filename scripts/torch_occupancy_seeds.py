"""Occupancy's coverage of its generating latents on the card, by training
seed, on the JAX latent-recovery test's own data
(``alan_tpu_torch/experiments/data/occupancy_jax_key0.npz``) and on the
port's fake data (numpy seed 0): QEM K=15, 150 steps, ``"0.03/t@60"``
(``tests/test_latent_recovery.py``'s occupancy settings), seeds 1-8, the
coverage read out at seed 2.  ``tests/occupancy_coverage_study.py`` is the
JAX package's side on the CPU.

    python3 scripts/torch_occupancy_seeds.py [SEEDS...]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from alan_tpu_torch import train  # noqa: E402
from alan_tpu_torch.experiments import latent_recovery  # noqa: E402
from alan_tpu_torch.experiments.occupancy_collapse_probe import coverage, load  # noqa: E402
from alan_tpu_torch.utils import seeded_generator  # noqa: E402


def main(seeds):
    dev = "cuda"
    cfg = latent_recovery.MODELS["occupancy"]
    out = {}
    for src in ("jax_test", "port"):
        for seed in seeds:
            if src == "jax_test":
                p, *_, lat = latent_recovery.occupancy_jax_test_data(dev)
            else:
                p, *_, lat = load("qem", 0, dev)
            el = train.fit(p, "qem", K=cfg["K"], iters=cfg["iters"], lr=cfg["lr"],
                           generator=seeded_generator(seed, dev), device=dev)
            cov, per, _ = coverage(p, lat, cfg["K"], seeded_generator(2, dev))
            out[src, seed] = cov
            print(src, "data, seed", seed, "coverage", round(cov, 4), "ELBO end",
                  float(el[-10:].mean()), {k: round(v, 2) for k, v in per.items()}, flush=True)
    for src in ("jax_test", "port"):
        c = [v for (s, _), v in out.items() if s == src]
        print(src, "data: coverage over seeds mean", np.mean(c), "min", min(c), "max", max(c))


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or list(range(1, 9)))
