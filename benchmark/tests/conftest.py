"""Shared pieces of the benchmark's tests: cells cut to sizes a CPU test
holds, and the fixture that skips a test needing the card."""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: configuration and traffic keys replaced to cut each cell for the CPU
CUTS = {
    "covid_qem_k30": ({"nRs": 4, "nDs": 15, "nDs_train": 12}, {"K": 5}),
    "movielens_grouped_vi_k1000": ({"M": 20}, {"K": 16}),
    "movielens_qem_k30": ({"M": 20}, {"K": 6}),
}
RUN = {"chunk": 3, "warm_chunks": 1}
#: seconds of a traced run's profiled chunks on the CPU
TRACE_SECONDS = 0.05


def small_spec(cell, limits=None):
    """The cell's spec with its sizes cut, and ``limits`` (default the
    cell's own) for ``correct``."""
    from benchmark import harness
    spec = copy.deepcopy(harness.cell_spec(cell))
    cfg, traffic = CUTS[cell]
    spec["config"].update(cfg)
    spec["traffic"].update(traffic, **RUN)
    if limits is not None:
        spec["workload"]["limits"] = dict(limits)
    return spec


@pytest.fixture
def card():
    """Skips where no CUDA card is present (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
