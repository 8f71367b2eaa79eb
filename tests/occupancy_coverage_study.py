"""Why occupancy's coverage of its generating latents sits below the JAX
test's 0.70 bar on the port's own fake data: the same study in both
packages, on the CPU (minutes; JAX's side is ``alan_tpu``'s).

    JAX_PLATFORMS=cpu python tests/occupancy_coverage_study.py [jax-seeds|jax-on-port|track]

* ``jax-seeds``: ``alan_tpu`` on its own fake data (the JAX test's, key 0),
  QEM K=15, 150 steps, ``"0.03/t@60"``, fit keys 1, 3, 5, 7, coverage read
  out at key 2; and the key-1 fit read out at keys 3-5;
* ``jax-on-port``: ``alan_tpu`` on the port's fake data
  (``alan_tpu_torch.models.occupancy.fake_arrays(0)``), fit keys 1-3;
* ``track``: 150 steps of both packages from ``alan_tpu``'s particles,
  drawn at ``alan_tpu``'s state each step and handed to the port's step:
  the ELBOs every 10 steps, then each package's coverage read out at four
  seeds.

The card's side (``scripts/torch_occupancy_seeds.py``) fits the port on
both datasets at eight seeds.
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for p in (REPO, HERE, os.path.join(REPO, "examples", "models"), os.path.join(REPO, "scripts")):
    sys.path.insert(0, p)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import occupancy_collapse_probe as jo  # noqa: E402
from alan_tpu import named  # noqa: E402
from alan_tpu import train as jtrain  # noqa: E402

FIT = dict(K=15, iters=150, lr="0.03/t@60")


def _jax_fit_coverage(problem, latents, key, readouts=(2,)):
    el = jtrain.fit(problem, method="qem", key=jax.random.key(key), **FIT)
    covs = [round(jo.coverage(problem, latents, FIT["K"], jax.random.key(r))[0], 4)
            for r in readouts]
    return covs, float(np.mean(np.asarray(el)[-10:]))


def jax_seeds():
    for key in (1, 3, 5, 7):
        problem, _, _, _, latents = jo.load("qem", 0)
        readouts = (2, 3, 4, 5) if key == 1 else (2,)
        print("JAX data, JAX fit key", key, "coverage by read-out key", readouts,
              *_jax_fit_coverage(problem, latents, key, readouts), flush=True)


def jax_on_port():
    import occupancy
    from alan_tpu_torch.models.occupancy import I, fake_arrays
    a = fake_arrays(0)
    n3 = ("plate_Years", "plate_Birds", "plate_Ids")
    cov = {k: named(jnp.asarray(a[k][:, :, :I]), *n3) for k in ("weather", "quality")}
    data = {"obs": named(jnp.asarray(a["obs"][:, :, :I]), *n3, "plate_Replicate")}
    ps = {"plate_Years": 6, "plate_Birds": 12, "plate_Ids": I, "plate_Replicate": 5}
    dims = {"bird_mean": ("plate_Birds",), "alpha": ("plate_Birds",), "beta": ("plate_Birds",),
            "bird_year_mean": ("plate_Years", "plate_Birds"), "z": n3}
    lat = {k: named(jnp.asarray(a[k]), *dims.get(k, ())) for k in (
        "bird_mean_mean", "bird_mean_log_var", "alpha_mean", "alpha_log_var", "beta_mean",
        "beta_log_var", "bird_mean", "alpha", "beta", "bird_year_mean", "z")}
    for key in (1, 2, 3):
        problem = occupancy.generate_problem(ps, data, cov, "qem")
        print("port data, JAX fit key", key, *_jax_fit_coverage(problem, lat, key), flush=True)


def track():
    from alan_tpu.sampler import PermutationSampler
    from alan_tpu_torch import convert
    from alan_tpu_torch import train as ttrain
    from alan_tpu_torch.experiments.occupancy_collapse_probe import coverage
    from alan_tpu_torch.models import occupancy as tocc
    from alan_tpu_torch.utils import seeded_generator
    from canonical_parity import port
    from test_torch_harness import to_numpy_tree
    jprob, _, _, _, jlat = jo.load("qem", 0)
    tprob = tocc.generate_problem(
        {"plate_Years": 6, "plate_Birds": 12, "plate_Ids": 200, "plate_Replicate": 5},
        port(dict(jprob._data)), port(dict(jprob.Q.inputs())), "qem", device="cpu")
    jstep, jst = jtrain.qem(jprob, FIT["K"], lr=FIT["lr"])
    jstep = jax.jit(jstep)
    tstep, tst = ttrain.qem(tprob, FIT["K"], lr=FIT["lr"], device="cpu")
    draw = jax.jit(lambda key, sQ: jprob.Q._sample(FIT["K"], False, PermutationSampler,
                                                   jprob.all_platedims, key, state=sQ)[0])
    t0 = time.time()
    for i in range(FIT["iters"]):
        key = jax.random.fold_in(jax.random.key(1), i)
        tree = convert.tree_from_numpy(to_numpy_tree(draw(key, jst[0][1])), "cpu")
        jst, je = jstep(jst, key)
        tst, te = tstep(tst, sample=tree)
        if i % 10 == 0 or i == FIT["iters"] - 1:
            print("step", i, "ELBO JAX", float(je), "port", float(te),
                  round(time.time() - t0, 1), flush=True)
    jprob.P.set_state(jst[0][0])
    jprob.Q.set_state(jst[0][1])
    tprob.P.set_state(tst[0][0])
    tprob.Q.set_state(tst[0][1])
    print("JAX state, JAX read-outs at keys 2-5",
          [round(jo.coverage(jprob, jlat, FIT["K"], jax.random.key(k))[0], 3) for k in (2, 3, 4, 5)])
    print("port state, port read-outs at seeds 2-5",
          [round(coverage(tprob, port(jlat), FIT["K"], seeded_generator(g, "cpu"))[0], 3)
           for g in (2, 3, 4, 5)])


if __name__ == "__main__":
    for part in sys.argv[1:] or ("jax-seeds", "jax-on-port", "track"):
        {"jax-seeds": jax_seeds, "jax-on-port": jax_on_port, "track": track}[part]()
