"""Multi-process runtime glue (counterpart of
``alan_tpu/parallel/distributed.py``).

A planned step runs as one process per rank: (1) ``initialize`` starts
``torch.distributed`` on each, (2) ``global_mesh`` builds a mesh over all
ranks from the same axis spec a ``MeshPlan`` uses, (3) every rank runs the
same step, and DTensor places the collectives.  ``initialize()`` does
nothing when no address is configured, so a single process keeps working
unchanged.
"""
from __future__ import annotations

import os

import torch

from .mesh import make_mesh


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, device_type: str = "cuda"):
    """Start ``torch.distributed`` when an address is configured, from the
    arguments or from the standard ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``RANK`` / ``WORLD_SIZE`` (``torchrun``'s); return False and do nothing
    otherwise.  NCCL for ``device_type="cuda"`` (each rank on the card of
    its ``LOCAL_RANK``), gloo for ``"cpu"``."""
    import torch.distributed as dist
    if init_method is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if addr is None or port is None:
            return False
        init_method = f"tcp://{addr}:{port}"
    world_size = int(world_size if world_size is not None
                     else os.environ.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % max(
            1, torch.cuda.device_count()))))
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device type {device_type}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def global_mesh(axis_sizes: dict[str, int], device_type: str | None = None):
    """Mesh over all ranks of the process group."""
    return make_mesh(axis_sizes, device_type=device_type)
