"""alan_tpu_torch -- the PyTorch/CUDA port of alan_tpu for an NVIDIA H100.

The package mirrors ``alan_tpu``'s module layout and names.  It imports
``torch`` and never JAX or ``alan_tpu``.  Entry points (``BoundPlate``,
``Problem``, ``train.qem``, ``train.vi``, ``train.rws``, ``train.fit``) take
a ``device``: ``"cuda"`` by default, which raises without a card; only an
explicit ``device="cpu"`` runs on the host.  The hand-written kernels
(``csrc/``) and the native planner build at first use into
``alan_tpu_torch/_native/``.

The port trains by QEM, VI and RWS (``OptParam``s and ``extra_opt_params``
under ``torch.optim.Adam``) and carries the MovieLens models, the covid
timeseries model and the ELBO of the AR(1) timeseries model.
"""

from .dims import DT, dt
from .bound import BoundPlate, named
from .ir import (Plate, Group, Data, Timeseries, OptParam, QEMParam, Normal,
                 Bernoulli, NegativeBinomial)
from .sampler import PermutationSampler
from .problem import Problem
from .sample import Sample
from .moments import mean, mean2
from .split import no_checkpoint
from . import train, convert

__all__ = [
    "DT", "dt", "named", "Plate", "BoundPlate", "Problem", "Group", "Data",
    "Timeseries", "OptParam", "QEMParam", "Normal", "Bernoulli",
    "NegativeBinomial",
    "PermutationSampler", "Sample", "mean", "mean2", "no_checkpoint",
    "train", "convert",
]
