"""Posterior read-out pipelines (counterpart of ``alan_tpu/predict.py``):
draw K particles from Q, importance-sample N joint draws by the reverse
replay, and, for the predictive log-likelihood, extend the plates and score
the held-out data.

``alan_tpu`` compiles each pipeline into one XLA program; here each is a
plain function of eager PyTorch on the problem's device.  Every draw
(particles, replay, prior extension) comes from one ``torch.Generator``,
whose state advances through the pipeline.  ``sample=`` (a particle tree)
replaces the particles' draw and ``noise=`` (Gumbel tensors in draw order)
the replay's, as ``train.elbo_fn`` takes them.
"""
from __future__ import annotations

from .sample import Sample
from .sampler import PermutationSampler
from .split import no_checkpoint


def _importance_sample(problem, K, N, sampler, computation_strategy, stateP,
                       stateQ, generator, sample, noise):
    if sample is None:
        if generator is None:
            raise ValueError("pass a generator, or a sample and noise")
        sample, gv2K = problem.Q._sample(K, False, sampler, problem.all_platedims,
                                         generator, state=stateQ)
    else:
        gv2K = problem.Q.plate.groupvarname2Kdim(K)
    s = Sample(problem, sample, gv2K, sampler, False, states=(stateP, stateQ))
    return s.importance_sample(N, generator, computation_strategy, noise=noise)


def importance_sample_fn(problem, K: int, N: int, sampler=PermutationSampler,
                         computation_strategy=no_checkpoint):
    """Returns ``f(stateP, stateQ, generator=None, sample=None, noise=None)
    -> dict[varname, DT]``: N posterior draws of every latent, each carrying
    the ``N`` dim and its plates (``problem.sample(K, generator)
    .importance_sample(N, generator).dump()`` at the given states)."""
    def f(stateP, stateQ, generator=None, sample=None, noise=None):
        return _importance_sample(problem, K, N, sampler, computation_strategy,
                                  stateP, stateQ, generator, sample, noise).dump()
    return f


def predictive_ll_fn(problem, K: int, N: int, extended_platesizes: dict,
                     sampler=PermutationSampler,
                     computation_strategy=no_checkpoint):
    """Returns ``f(stateP, stateQ, extended_inputs, all_data,
    generator=None, sample=None, noise=None) -> dict[varname, tensor]``:
    the predictive log-likelihood of each data variable in ``all_data``
    (over the extended plates) given N importance samples.  The prior draws
    of the extension need ``generator`` even where ``sample`` and ``noise``
    are given."""
    extended_platesizes = dict(extended_platesizes)

    def f(stateP, stateQ, extended_inputs, all_data, generator=None,
          sample=None, noise=None):
        isamp = _importance_sample(problem, K, N, sampler, computation_strategy,
                                   stateP, stateQ, generator, sample, noise)
        ext = isamp.extend(dict(extended_platesizes), extended_inputs, generator)
        return {k: v.data for k, v in ext.predictive_ll(all_data).items()}

    return f
