"""alan_tpu_torch -- the PyTorch/CUDA port of alan_tpu for an NVIDIA H100.

The package mirrors ``alan_tpu``'s module layout and names.  It imports
``torch`` and never JAX or ``alan_tpu``.  Entry points (``BoundPlate``,
``Problem``, ``train.qem``, ``train.vi``, ``train.rws``, ``train.fit``) take
a ``device``: ``"cuda"`` by default, which raises without a card; only an
explicit ``device="cpu"`` runs on the host.  The hand-written kernels
(``csrc/``) and the native planner build at first use into
``alan_tpu_torch/_native/``.

It carries every distribution family of ``alan_tpu`` (35), their QEM
conversions and the factored low-rank forms of six of them.  The port
trains by QEM, VI and RWS (``OptParam``s and ``extra_opt_params`` under
``torch.optim.Adam``), and by their global-K (non-MP, IWAE-style)
baselines (``train.global_vi`` / ``global_rws`` / ``global_qem``,
``Problem.sample_nonmp``, ``SampleNonMP``).  ``train.scan_steps`` and
``train.vmap_runs`` run a loop of steps, and independent runs, as CUDA
graphs replayed on the card (the eager loop on the CPU).  It carries the
MovieLens models, the covid timeseries model (with its factorised Q or
the ``corr_Q`` MultivariateNormal proposal) and the AR(1) timeseries
model.  A Timeseries may stand in Q, drawing K particles permuted step
by step.

It reads a posterior out: moments (``Sample.moments``; ``mean``, ``var``,
``std_from_raw_moment`` and the rest of ``moments``), the marginal weights
of the particles (``Sample.marginals()``, with their ESS), importance
samples (``Sample.importance_sample(N, generator)``, by the reverse replay
of the contraction, and a timeseries plate's by forward filtering and
backward sampling) and the predictive log-likelihood of held-out data
(``ImportanceSample.extend(...).predictive_ll(...)``, a timeseries rolled
forward from its last state; ``predict.importance_sample_fn`` and
``predict.predictive_ll_fn`` run the whole pipeline).

Every evaluation takes a computation strategy (``no_checkpoint``,
``checkpoint``, ``Split``; ``alan_tpu``'s defaults).  ``checkpointing``
saves and resumes a training state bit-exactly, in ``alan_tpu``'s file
layout.  The gold samplers ``mcmc.run_hmc``, ``nuts.run_nuts`` and
``smc.run_smc`` sample the P program's posterior (each HMC and NUTS
iteration a CUDA graph on the card), and ``diagnostics`` reads their
draws.

``perf`` counts a step's model FLOPs and its share of the card's peak,
``profiling`` traces and times steps, ``parallel`` shards a step over the
ranks of a ``torch.distributed`` group (``MeshPlan``, DTensor layouts),
and ``python -m alan_tpu_torch.runner`` is ``examples/runner.py``'s
counterpart.
"""

from .dims import DT, dt
from .bound import BoundPlate, named
from .ir import Plate, Group, Data, Timeseries, OptParam, QEMParam, new_dist
from .sampler import (PermutationSampler, CategoricalSampler, IndependentSampler,
                      samplers)
from .problem import Problem
from .sample import Sample
from .sample_nonmp import SampleNonMP
from .marginals import Marginals
from .importance import ImportanceSample, ExtendedImportanceSample
from .moments import (RawMoment, CompoundMoment, mean, mean2, mean_log, mean_log1m,
                      mean_recip, mean_xxT, var, cov_x, var_from_raw_moment,
                      std_from_raw_moment)
from .split import Split, checkpoint, no_checkpoint
from . import train, convert, predict
# subsystem modules (alan_tpu_torch.perf.mfu_report, .parallel.mesh.MeshPlan, ...)
from . import perf, profiling, parallel  # noqa: E402

# the user-facing constructor of every family (Normal, Beta, ...)
from .ir.dist import _dist_calls as _dc
globals().update(_dc)

__all__ = [
    "DT", "dt", "named", "Plate", "BoundPlate", "Problem", "Group", "Data",
    "Timeseries", "OptParam", "QEMParam", "new_dist",
    "PermutationSampler", "CategoricalSampler", "IndependentSampler",
    "samplers", "Sample", "SampleNonMP", "Marginals", "ImportanceSample",
    "ExtendedImportanceSample", "RawMoment", "CompoundMoment", "mean",
    "mean2", "mean_log", "mean_log1m", "mean_recip", "mean_xxT", "var",
    "cov_x", "var_from_raw_moment", "std_from_raw_moment", "Split", "checkpoint", "no_checkpoint",
    "train", "convert", "predict", "perf", "profiling", "parallel",
    *list(_dc.keys()),
]
