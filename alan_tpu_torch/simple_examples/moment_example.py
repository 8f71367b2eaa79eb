"""Moments three ways (counterpart of
``examples/simple_examples/moment_example.py``): the sample's source terms,
the marginals and importance samples.  Returns the first two, which agree
up to float rounding (both read the same marginal weights)."""
import numpy as np
import torch

from alan_tpu_torch import (BoundPlate, Data, Group, Normal, Plate, Problem, mean, named,
                            var)
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

    print("ELBO vs K:")
    for i, K in enumerate([1, 3, 10, 30, 100]):
        elbo = prob.sample(K, seeded_generator(i, device)).elbo_nograd()
        print(f"  K={K:4d}: {float(elbo):.4f}")

    sample = prob.sample(100, seeded_generator(10, device), reparam=False)
    marginals = sample.marginals()
    print("\nMoments from marginals:")
    from_marginals, from_sample = {}, {}
    for vn in ["a", "b", "c", "d"]:
        m = from_marginals[vn] = marginals.moments(vn, mean)
        v = marginals.moments(vn, var)
        print(f"  E[{vn}] =", m.data.cpu().numpy().round(3),
              f" Var[{vn}] =", v.data.cpu().numpy().round(3))

    print("\nSame moments from the source-term trick (sample.moments):")
    for vn in ["a", "b", "c", "d"]:
        from_sample[vn] = sample.moments(vn, mean)
        print(f"  E[{vn}] =", from_sample[vn].data.cpu().numpy().round(3))

    isample = sample.importance_sample(1000, seeded_generator(11, device))
    print("\nSame moments from importance samples:")
    for vn in ["a", "b", "c", "d"]:
        print(f"  E[{vn}] =", isample.moments(vn, mean).data.cpu().numpy().round(3))

    print("\nmin ESS:", float(marginals.min_ess()))
    return from_sample, from_marginals


if __name__ == "__main__":
    main()
