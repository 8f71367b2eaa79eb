"""Double-timeseries demo (counterpart of
``examples/simple_examples/timeseries.py``).

Part 1 groups the two chains so they share one K-dim (one K x K chain).
Part 2 leaves them ungrouped: each chain keeps its own K-dim and the
engine contracts the joint [T, K^2, K^2] product chain (O(K^4) memory:
keep K small or group)."""
from alan_tpu_torch import BoundPlate, Data, Group, Normal, Plate, Problem, Timeseries
from alan_tpu_torch.simple_examples import device_of
from alan_tpu_torch.utils import seeded_generator


def main(argv=None):
    device = device_of(argv, __doc__)
    P = Plate(
        gp1=Group(
            ts1_init=Normal(0., 1.),
            ts2_init=Normal(0., 1.),
        ),
        T=Plate(
            gp2=Group(
                ts1=Timeseries('ts1_init', Normal(lambda prev: 0.9 * prev, 0.1)),
                ts2=Timeseries('ts2_init', Normal(lambda ts1, prev: 0.9 * ts1 + prev, 0.1)),
                a=Normal('ts2', 1.),
            ),
        ),
    )

    Q = Plate(
        gp1=Group(
            ts1_init=Normal(0., 1.),
            ts2_init=Normal(0., 1.),
        ),
        T=Plate(
            gp2=Group(
                ts1=Normal(0., 1.),
                ts2=Normal(0., 1.),
            ),
            a=Data(),
        ),
    )

    bP = BoundPlate(P, {'T': 3}, device=device)
    bQ = BoundPlate(Q, {'T': 3}, device=device)

    data = {'a': bP.sample(seeded_generator(0, device))['a']}

    problem = Problem(bP, bQ, data, device=device)
    sample = problem.sample(10, seeded_generator(1, device))
    elbo = float(sample.elbo_vi())
    print("elbo:", elbo)

    # ---- part 2: the same two chains ungrouped (each keeps its own K-dim;
    # the engine contracts the joint product chain, exactly, O(K^4) memory) ----
    Q_ungrouped = Plate(
        ts1_init=Normal(0., 1.),
        ts2_init=Normal(0., 1.),
        T=Plate(
            ts1=Normal(0., 1.),
            ts2=Normal(0., 1.),
            a=Data(),
        ),
    )
    problem_u = Problem(bP, BoundPlate(Q_ungrouped, {'T': 3}, device=device), data,
                        device=device)
    sample_u = problem_u.sample(10, seeded_generator(2, device))
    elbo_u = float(sample_u.elbo_vi())
    print("elbo (ungrouped, joint chain):", elbo_u)
    isamp = sample_u.importance_sample(20, seeded_generator(3, device))
    print("joint-FFBS posterior draws:", isamp.dump()['ts1'].dims)
    return elbo, elbo_u


if __name__ == "__main__":
    main()
