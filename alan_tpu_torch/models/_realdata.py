"""Real-dataset loading for the canonical models (the port's own copy of
``examples/models/_realdata.py``).

The reference's model loaders read ``.pt`` tensors from a ``data/``
directory; the files are not in this repository, users produce them with
the reference's data-munging scripts.  These helpers honour the same file
names, so a dataset directory prepared for the reference works with any
canonical model's ``load_data_covariates(..., fake_data=False,
data_dir=...)``.  ``<stem>.pt`` loads through torch, ``<stem>.npy`` through
numpy.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def load_array(data_dir, stem):
    """``<data_dir>/<stem>.pt`` or ``<stem>.npy`` as numpy, float64 cast to
    float32.  Raises FileNotFoundError naming both candidates if absent."""
    pt = os.path.join(data_dir, stem + ".pt")
    npy = os.path.join(data_dir, stem + ".npy")
    if os.path.exists(pt):
        x = torch.load(pt, map_location="cpu", weights_only=True)
        a = x.detach().numpy() if hasattr(x, "detach") else np.asarray(x)
    elif os.path.exists(npy):
        a = np.load(npy)
    else:
        raise FileNotFoundError(
            f"real dataset file not found: {pt} or {npy} "
            f"(pass fake_data=True to generate data from the prior)")
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return a


def load_train_test(data_dir, train_stem, test_stem, axis):
    """A train/test pair: (train, concat(train, test, axis)), the
    reference's extended-data construction."""
    tr = load_array(data_dir, train_stem)
    te = load_array(data_dir, test_stem)
    return tr, np.concatenate([tr, te], axis=axis)


def split_dts(arrays, dims, axis, n_train, device):
    """``{name: numpy array over the extended plates}`` -> (the training
    part, the first ``n_train`` along ``axis``; the whole), each a dict of
    ``DT``s with ``dims`` on ``device``."""
    from ..convert import dt_from_numpy
    cut = lambda a: np.take(a, np.arange(n_train), axis=axis)
    return ({k: dt_from_numpy(cut(a), dims, device) for k, a in arrays.items()},
            {k: dt_from_numpy(a, dims, device) for k, a in arrays.items()})


def fake_latents(P, arrays, data, plates, device):
    """The latents fake data were drawn from (``alan_tpu``'s
    ``return_fake_latents``): ``{name: DT}`` for every latent of the P
    program ``P`` (a BoundPlate over the extended plates) found in the
    numpy ``arrays``, over the extended plates.  An array's leading axes
    are the plates that hold its latent, in the order of ``plates`` (the
    model's axis order); the names of ``data`` are skipped."""
    from ..convert import dt_from_numpy
    from ..ir import Plate
    out = {}

    def walk(plate, inside):
        for k, v in plate.flat_prog.items():
            if isinstance(v, Plate):
                walk(v, {*inside, k})
            elif k in arrays and k not in data:
                if not inside <= set(plates):
                    raise ValueError(f"{k}: plates {sorted(inside)} not all in {plates}")
                out[k] = dt_from_numpy(arrays[k], [d for d in plates if d in inside],
                                       device)
    walk(P.plate, set())
    return out


def check_fake(fake_data, return_fake_latents):
    if return_fake_latents and not fake_data:
        raise ValueError("return_fake_latents requires fake_data=True")
