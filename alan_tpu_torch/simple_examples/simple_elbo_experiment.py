"""ELBO tightening with K (counterpart of
``examples/simple_examples/simple_elbo_experiment.py``): the mean ELBO
over independent runs rises towards log p(data) as K grows."""
import numpy as np
import torch

from alan_tpu_torch import BoundPlate, Data, Group, Normal, Plate, Problem, named
from alan_tpu_torch.simple_examples import device_of
from alan_tpu_torch.utils import fold_seed, seeded_generator

num_runs = 20
Ks = [1, 10, 100]
platesizes = {'p1': 3, 'p2': 4}


def build(data, device):
    P = Plate(
        ab=Group(a=Normal(0, 1), b=Normal("a", 1)),
        c=Normal(0, lambda a: a.exp()),
        p1=Plate(d=Normal("a", 1), p2=Plate(e=Normal("d", 1.))),
    )
    Q = Plate(
        ab=Group(a=Normal(0, 1), b=Normal("a", 1)),
        c=Normal(0, lambda a: a.exp()),
        p1=Plate(d=Normal("a", 1), p2=Plate(e=Data())),
    )
    return Problem(BoundPlate(P, platesizes, device=device),
                   BoundPlate(Q, platesizes, device=device), data, device=device)


def main(argv=None):
    device = device_of(argv, __doc__)
    rng = np.random.default_rng(0)
    data = {'e': named(torch.tensor(rng.standard_normal((3, 4)), dtype=torch.float32),
                       'p1', 'p2')}
    prob = build(data, device)
    print("mean ELBO over runs (higher K => tighter bound):")
    means = {}
    for K in Ks:
        elbos = [float(prob.sample(K, seeded_generator(fold_seed(1, r), device))
                       .elbo_nograd()) for r in range(num_runs)]
        means[K] = float(np.mean(elbos))
        print(f"  K={K:4d}: {means[K]:8.3f} ± {np.std(elbos) / np.sqrt(num_runs):.3f}")
    return means


if __name__ == "__main__":
    main()
