"""Production mesh builders, and the H100 constants of the roofline.

The PyTorch counterpart of ``src/repro/launch/mesh.py``.  A mesh is a torch
``DeviceMesh`` with named dims.  On a process whose default process group
is not of the mesh's size (a dry-run on one card or on the CPU), the mesh
comes from a fake process group of that size (``fake_pg``): collectives on
it return at once and move nothing, which is all a trace over fake tensors
needs.  The fake group is (re)made per mesh size; a real group of another
size is an error.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _world(size: int) -> None:
    """A default process group of ``size`` ranks, this process rank 0."""
    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group of "
                               f"{dist.get_world_size()} ranks cannot hold a "
                               f"mesh of {size}")
        dist.destroy_process_group()
    # private to torch's tests, and the one way to a group of 256 ranks
    # without 256 processes
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def make_mesh(shape: tuple, axes: tuple, *, device: str = "cuda"):
    _world(math.prod(shape))
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_dev_mesh(data: int = 1, model: int = 1, *, device: str = "cuda"):
    """A small (data, model) mesh (tests; the card check at (1, 1))."""
    return make_mesh((data, model), ("data", "model"), device=device)


# NVIDIA H100 SXM5 (700 W) datasheet figures, per card; not measured here
PEAK_FLOPS_BF16 = 989.4e12       # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                 # HBM3 bytes/s
NVLINK_BW = 900e9                # NVLink 4 bytes/s per card, inside a node
NVLINK_DOMAIN = 8                # cards per NVLink domain (HGX H100)
INTER_NODE_BW = 50e9             # bytes/s per card between nodes: one
                                 # 400 Gb/s NDR InfiniBand port per card
