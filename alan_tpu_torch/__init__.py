"""alan_tpu_torch -- the PyTorch/CUDA port of alan_tpu for an NVIDIA H100.

The package mirrors ``alan_tpu``'s module layout and names.  It imports
``torch`` and never JAX or ``alan_tpu``.  Entry points (``BoundPlate``,
``Problem``, ``train.qem``) take a ``device``: ``"cuda"`` by default, which
raises without a card; only an explicit ``device="cpu"`` runs on the host.
The hand-written kernels (``csrc/``) and the native planner build at first
use into ``alan_tpu_torch/_native/``.

This slice carries the fused QEM step of the MovieLens models.
"""

from .dims import DT, dt
from .bound import BoundPlate, named
from .ir import Plate, Group, Data, Timeseries, OptParam, QEMParam, Normal, Bernoulli
from .sampler import PermutationSampler
from .problem import Problem
from .sample import Sample
from .moments import mean, mean2
from .split import no_checkpoint
from . import train, convert

__all__ = [
    "DT", "dt", "named", "Plate", "BoundPlate", "Problem", "Group", "Data",
    "Timeseries", "OptParam", "QEMParam", "Normal", "Bernoulli",
    "PermutationSampler", "Sample", "mean", "mean2", "no_checkpoint",
    "train", "convert",
]
