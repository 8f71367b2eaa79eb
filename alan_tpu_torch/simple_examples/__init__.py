"""The simple examples of the public API (the port's counterparts of
``examples/simple_examples/``), each runnable as

    python -m alan_tpu_torch.simple_examples.<name> [--device cpu]

and each a ``main(argv=None)`` that a test may call with
``["--device", "cpu"]``."""
from __future__ import annotations

import argparse


def device_of(argv, doc):
    """The ``--device`` of a simple example's command line (default the
    card)."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    return ap.parse_args(argv).device
