"""The occupancy data of ``tests/test_latent_recovery.py``: ``alan_tpu``'s
fake data at ``jax.random.key(0)`` (``examples/models/occupancy.py``) and
the latents it was drawn from, saved as numpy for the port, which cannot
draw JAX's random numbers.  ``alan_tpu_torch.experiments.latent_recovery``
holds its occupancy coverage to the JAX test's bar on these data;
``tests/test_torch_experiments.py`` holds the file to the JAX loader.

    JAX_PLATFORMS=cpu python tests/occupancy_fixture.py    # rewrite the file
"""
import json
import os
import sys

import jax
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH = os.path.join(REPO, "alan_tpu_torch", "experiments", "data", "occupancy_jax_key0.npz")


def jax_arrays():
    """{name: (numpy array, dims)}: the training data and covariates and
    the latents, as ``alan_tpu``'s loader gives them at key 0."""
    for p in (REPO, os.path.join(REPO, "examples", "models"),
              os.path.dirname(os.path.abspath(__file__))):
        if p not in sys.path:
            sys.path.insert(0, p)
    import occupancy
    from canonical_parity import quick_compiles
    with quick_compiles():
        out = jax.jit(lambda key: occupancy.load_data_covariates(
            key=key, return_fake_latents=True))(jax.random.key(0))
    data, cov, lat = out[2], out[4], out[6]
    return {k: (np.asarray(v.data), tuple(v.dims))
            for tree in (data, cov, lat) for k, v in tree.items()}


def write(path=PATH):
    arrays = jax_arrays()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, dims=np.array(json.dumps({k: d for k, (_, d) in arrays.items()})),
                        **{k: a for k, (a, _) in arrays.items()})


if __name__ == "__main__":
    write()
    print(PATH, os.path.getsize(PATH))
