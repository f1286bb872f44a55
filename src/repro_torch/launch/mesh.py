"""Mesh construction: ``DeviceMesh``es with named dimensions.

The counterpart of the reference's ``repro/launch/mesh.py``.  Functions,
never module-level constants, so importing this module touches no
process group: the caller initialises one first (NCCL with one card a
rank, gloo for several ranks on one card or on the CPU, or the fake
group of the dry-run), and the mesh spans its ranks.
"""
from __future__ import annotations

import torch


def _mesh(device_type: str, shape, names):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device_type='cpu' for a mesh of "
            "CPU ranks")
    if not dist.is_initialized():
        raise RuntimeError("initialise a torch.distributed process group "
                           "first (the mesh spans its ranks)")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``, over a group of 256 or 512 ranks (the
    dry-run's fake group, on ``device_type="cpu"``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, names)


def make_local_mesh(model_parallel: int = 1, device_type: str = "cuda"):
    """(world / model_parallel, model_parallel) ``("data", "model")`` over
    the initialised group's ranks, on the card by default (without CUDA
    this raises; pass ``device_type="cpu"`` for CPU ranks)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("initialise a torch.distributed process group "
                           "first (the mesh spans its ranks)")
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model-parallel "
                         f"groups of {model_parallel}")
    return _mesh(device_type, (n // model_parallel, model_parallel),
                 ("data", "model"))
