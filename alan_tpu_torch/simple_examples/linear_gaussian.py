"""Minimal linear-Gaussian workflow (counterpart of
``examples/simple_examples/linear_gaussian.py``): one vector latent,
plated observations, importance-sample -> extend -> predictive
log-likelihood.

Vector parameters carry a trailing positional axis in the DT convention."""
import numpy as np
import torch

from alan_tpu_torch import BoundPlate, Data, Normal, Plate, Problem, named
from alan_tpu_torch.simple_examples import device_of
from alan_tpu_torch.utils import seeded_generator


def main(argv=None):
    device = device_of(argv, __doc__)
    P = Plate(
        mu=Normal(torch.zeros(2), torch.ones(2)),
        p1=Plate(
            obs=Normal("mu", torch.ones(2)),
        ),
    )

    Q = Plate(
        mu=Normal("mu_mean", torch.ones(2)),
        p1=Plate(
            obs=Data(),
        ),
    )

    platesizes = {'p1': 3}
    rng = np.random.default_rng(0)
    data = {'obs': named(torch.tensor(rng.standard_normal((3, 2)), dtype=torch.float32), 'p1')}

    P = BoundPlate(P, platesizes, device=device)
    Q = BoundPlate(Q, platesizes, extra_opt_params={'mu_mean': torch.zeros(2)}, device=device)

    prob = Problem(P, Q, data, device=device)

    K = 4
    N = 100

    sample = prob.sample(K, seeded_generator(0, device))
    print(sample.detached_sample)

    importance_sample = sample.importance_sample(N, seeded_generator(1, device))
    for k, v in importance_sample.dump().items():
        print(k, v)

    extended_platesizes = {'p1': 4}
    extended_importance_sample = importance_sample.extend(
        extended_platesizes, None, seeded_generator(2, device))
    for k, v in extended_importance_sample.dump().items():
        print(k, v)

    extended_data = {'obs': named(torch.tensor(rng.standard_normal((4, 2)),
                                               dtype=torch.float32), 'p1')}
    ll = extended_importance_sample.predictive_ll(extended_data)
    print("predictive_ll:", float(ll['obs'].data))
    return ll


if __name__ == "__main__":
    main()
