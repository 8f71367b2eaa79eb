"""Posterior-predictive workflow (counterpart of
``examples/simple_examples/predictive_example.py``): importance-sample,
extend the plates, compute the predictive log-likelihood."""
import numpy as np
import torch

from alan_tpu_torch import BoundPlate, Data, Group, Normal, Plate, Problem, named
from alan_tpu_torch.simple_examples import device_of
from alan_tpu_torch.utils import seeded_generator


def main(argv=None):
    device = device_of(argv, __doc__)
    P = Plate(
        ab=Group(
            a=Normal(0, 1),
            b=Normal("a", 1),
        ),
        c=Normal(0, lambda a: a.exp()),
        p1=Plate(
            d=Normal("a", 1),
            p2=Plate(
                e=Normal("d", 1.),
            ),
        ),
    )

    Q = Plate(
        ab=Group(
            a=Normal("a_mean", 1),
            b=Normal("a", 1),
        ),
        c=Normal(0, lambda a: a.exp()),
        p1=Plate(
            d=Normal("d_mean", 1),
            p2=Plate(
                e=Data(),
            ),
        ),
    )

    platesizes = {'p1': 3, 'p2': 4}
    rng = np.random.default_rng(0)
    data = {'e': named(torch.tensor(rng.standard_normal((3, 4)), dtype=torch.float32),
                       'p1', 'p2')}

    P = BoundPlate(P, platesizes, device=device)
    Q = BoundPlate(Q, platesizes,
                   extra_opt_params={'a_mean': torch.zeros(()),
                                     'd_mean': named(torch.zeros(3), 'p1')},
                   device=device)

    prob = Problem(P, Q, data, device=device)

    sample = prob.sample(5, seeded_generator(0, device))
    importance_sample = sample.importance_sample(10, seeded_generator(1, device))

    extended_platesizes = {'p1': 5, 'p2': 6}
    predictive_samples = importance_sample.extend(extended_platesizes, None,
                                                  seeded_generator(2, device))
    for k, v in predictive_samples.dump().items():
        print(k, v)

    test_data = {'e': named(torch.tensor(rng.standard_normal((5, 6)), dtype=torch.float32),
                            'p1', 'p2')}
    pll = predictive_samples.predictive_ll(test_data)
    print("predictive_ll:", {k: float(v.data) for k, v in pll.items()})
    return pll


if __name__ == "__main__":
    main()
