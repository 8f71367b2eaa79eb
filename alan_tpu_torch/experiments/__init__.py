"""The quality experiments: the port's counterpart of the JAX package's
experiment scripts under ``scripts/`` and of the statistical gates of
``tests/test_latent_recovery.py``.  Each module runs as

    python -m alan_tpu_torch.experiments.<name> [--device cpu] [--out-dir DIR]

with the JAX script's arguments and defaults, on the card unless
``--device cpu`` is given, and writes a JSON record carrying every key of
the JAX script's record into ``--out-dir`` (default ``results_torch/``):

- ``moments_vs_hmc_covid``: MP QEM moments on reduced covid against NUTS
  (or HMC) and a second, independent gold run;
- ``covid_k_sweep``: the same gold, SMC on the same posterior, and MP at
  K = 10, 30, 100, 300;
- ``covid_smc_particle_trend``: SMC against the gold by particle count;
- ``covid_corrq_probe``: the ``corr_Q`` proposal against a factorised
  control;
- ``covid_full_qem_quality``: full-size covid QEM, segment by segment,
  against the latents that generated its counts;
- ``ffbs_coupling_sweep``: both FFBS routes against an analytic Kalman
  posterior as two chains couple;
- ``occupancy_collapse_probe``: occupancy's coverage of its generating
  latents under seven training configurations;
- ``latent_recovery``: the checks of ``tests/test_latent_recovery.py``.

``covid_recipe`` holds what the covid experiments share: the
realistic-count problem, the z metric and the cached NUTS gold.  Draws come
from ``torch.Generator``s seeded ``seed + n`` where the JAX script used
``jax.random.key(seed + n)``; the counts come from the same numpy
generator as the JAX script's, so they are bitwise its counts, but the
covariates are the port's own fake data (``models/covid.fake_data``), so
the records compare with the JAX package's in trend, not coordinate by
coordinate.
"""
