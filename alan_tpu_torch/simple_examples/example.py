"""Canonical full-API demo (counterpart of
``examples/simple_examples/example.py``): define P and Q, sample, compute
the ELBO, posterior moments, marginals, importance samples, and run one
update of each training method (QEM, VI, RWS).

Training goes through ``train.fit`` (one step of each method's factory);
a VI step is ``train.vi``'s step, not a hand-written ``elbo.backward()``.
"""
import torch

from alan_tpu_torch import (BoundPlate, Data, Group, Normal, OptParam, Plate, Problem,
                            QEMParam, checkpoint, mean, train, var)
from alan_tpu_torch.simple_examples import device_of
from alan_tpu_torch.utils import seeded_generator


def main(argv=None):
    device = device_of(argv, __doc__)
    computation_strategy = checkpoint  # no_checkpoint / checkpoint / Split('p1', 3)

    P_plate = Plate(
        a=Normal(OptParam(0., name='a_loc_P'), 1),
        bc=Group(
            b=Normal('a', 1),
            c=Normal('b', 1),
        ),
        d=Normal(0, lambda c: c.exp()),
        p1=Plate(
            e=Normal("d", 1),
            p2=Plate(
                f=Normal("e", 1.),
            ),
        ),
    )

    Q_plate = Plate(
        a=Normal(OptParam(0.), OptParam(1.)),
        bc=Group(
            b=Normal(QEMParam(0.), QEMParam(1.)),
            c=Normal('c_loc', lambda c_log_scale: c_log_scale.exp()),
        ),
        d=Normal(0, lambda c: c.exp()),
        p1=Plate(
            e=Normal(QEMParam(0.), QEMParam(1.)),
            p2=Plate(
                f=Data(),
            ),
        ),
    )

    all_platesizes = {'p1': 4, 'p2': 6}
    extra_opt_params = {'c_loc': torch.zeros(()), 'c_log_scale': torch.zeros(())}

    P_bound_plate = BoundPlate(P_plate, all_platesizes, device=device)
    Q_bound_plate = BoundPlate(Q_plate, all_platesizes,
                               extra_opt_params=extra_opt_params, device=device)

    # draw synthetic data from the prior
    P_sample = P_bound_plate.sample(seeded_generator(0, device))
    data = {'f': P_sample['f']}

    problem = Problem(P_bound_plate, Q_bound_plate, data, device=device)

    sample = problem.sample(10, seeded_generator(1, device))

    # ELBOs
    print("elbo_vi:     ", float(sample.elbo_vi(computation_strategy=computation_strategy)))
    print("elbo_rws:    ", float(sample.elbo_rws(computation_strategy=computation_strategy)))
    print("elbo_nograd: ", float(sample.elbo_nograd(computation_strategy=computation_strategy)))

    # One QEM update through the object API
    problem.sample(10, seeded_generator(2, device), reparam=False).update_qem_params(
        0.1, computation_strategy=computation_strategy)

    # One step of each training method
    for method in ("vi", "rws", "qem"):
        elbos = train.fit(problem, method=method, K=10, iters=1, device=device)
        print(f"one {method} step, elbo:", float(elbos[-1]))

    # Posterior moments three ways
    sample = problem.sample(10, seeded_generator(3, device), reparam=False)
    print("E[a] (sample.moments):   ", float(sample.moments('a', mean).data))
    marginals = sample.marginals()
    print("E[a] (marginals.moments):", float(marginals.moments('a', mean).data))
    print("Var[a]:                  ", float(marginals.moments('a', var).data))
    print("min ESS:                 ", float(marginals.min_ess()))

    importance_sample = sample.importance_sample(100, seeded_generator(4, device))
    print("E[a] (importance sample):", float(importance_sample.moments('a', mean).data))

    # Prediction: extend p1 and compute the predictive log-likelihood of
    # data over the extended plates (a prior draw at the extended sizes)
    extended_platesizes = {'p1': 6, 'p2': 6}
    extended = importance_sample.extend(extended_platesizes,
                                        generator=seeded_generator(5, device))
    P_ext = BoundPlate(P_plate, extended_platesizes, device=device)
    all_data = {'f': P_ext.sample(seeded_generator(6, device))['f']}
    pll = extended.predictive_ll(all_data)
    print("predictive_ll:", {k: float(v.data) for k, v in pll.items()})
    return pll


if __name__ == "__main__":
    main()
