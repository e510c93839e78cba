"""The client mesh; the port of the client half of `repro/sharding.py`.

The reference is single-controller: one process holds every device, and
GSPMD turns placement declarations into shardings and collectives. The port
is multi-controller, in PyTorch's own model: one process a rank under
`torch.distributed`, each holding its block of the fleet's clients. The
mesh is a `torch.distributed.device_mesh.DeviceMesh` with one axis,
"clients", built over the caller's process group, and a placement is a
DTensor placement tuple: `(Shard(0),)` for a leading client axis split over
the ranks, `(Replicate(),)` for a value every rank holds whole.

The LM launch path's rules (`param_spec`, `tree_param_specs`, `batch_spec`,
`head_axis_plan`, `set_hints`/`constrain`) are not here: they come with the
LM multi-device slice (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist

CLIENTS = "clients"


def _device_type() -> str:
    """The device type of the default process group's backend: NCCL's
    collectives run on CUDA tensors, gloo's on CPU tensors."""
    return "cuda" if "nccl" in str(dist.get_backend()) else "cpu"


def client_mesh(n: Optional[int] = None):
    """A 1-D `DeviceMesh` with the axis ("clients",) over the first `n`
    ranks of the default process group (all of them by default), on the
    device type of its backend. The process group must be initialized
    (`torch.distributed.init_process_group`, with its address, world size
    and rank given); nothing is started here, and nothing falls back to a
    single process."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "client_mesh needs an initialized torch.distributed process "
            "group: call init_process_group(backend, init_method=..., "
            "world_size=W, rank=r) in every rank first")
    n = dist.get_world_size() if n is None else int(n)
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=(CLIENTS,))


def axis_size(mesh, name: str) -> int:
    """The number of ranks along mesh axis `name`, 1 for an axis the mesh
    does not have."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def replicated(mesh) -> Tuple:
    """Every rank holds the whole value: `Replicate()` on every mesh axis."""
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


def leading_axis(mesh, axis: str) -> Tuple:
    """The leading dim split over mesh axis `axis` in contiguous blocks, one
    a rank in rank order (`Shard(0)`), replicated over any other axis."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return tuple(Shard(0) if a == axis else Replicate() for a in names)
