"""Sharding the port's steps over ranks: ``mesh`` (``MeshPlan``, DTensor
layouts), ``seq`` (the T-sharded timeseries chain), ``distributed``
(process-group start-up) and ``collective_audit`` (the collectives a step
issues, and a scaling model)."""

from . import collective_audit, distributed, mesh, seq  # noqa: E402,F401
