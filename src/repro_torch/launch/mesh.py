"""Production meshes, the port of `repro/launch/mesh.py`.

Axes:
  pod   - CoRS client axis (multi-pod only). Gradients are never reduced
          over it; the paper's representation exchange is its only traffic.
  data  - batch / FSDP axis.
  model - tensor-parallel axis.

The reference builds a `jax.sharding.Mesh` over 256 or 512 devices (fake
host devices in its dry-run). The port is multi-controller: a mesh of
ranks exists only once that many processes have joined a process group.
So a mesh comes in two forms, and the sharding rules (`sharding.py`,
`launch/serve.py`, `launch/train.py`) read only the axis names and sizes,
which both give:

  - `MeshShape`: names and sizes alone, touching no process group. The
    production meshes are these, so the dry-run can reckon a 512-rank mesh
    in one process;
  - a `torch.distributed.device_mesh.DeviceMesh` (`device_mesh`), over an
    initialized process group, on which DTensors are placed and steps run.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, with the part of `DeviceMesh`'s
    interface the sharding rules read (`mesh_dim_names`, `ndim`,
    `size(dim)`), and the reference's `mesh.shape` dict."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return self.axis_names

    @property
    def ndim(self) -> int:
        return len(self.sizes)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    def size(self, dim: Optional[int] = None) -> int:
        if dim is not None:
            return self.sizes[dim]
        n = 1
        for s in self.sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model") with `multi_pod`."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh() -> MeshShape:
    """The one-rank mesh: the same axis names, sizes 1."""
    return MeshShape(("data", "model"), (1, 1))


def device_mesh(shape: MeshShape, device_type: Optional[str] = None):
    """A `DeviceMesh` with `shape`'s axis names and sizes over the
    initialized default process group, whose world size must be their
    product; `device_type` defaults to that of the group's backend ("cuda"
    under NCCL, "cpu" under gloo). Nothing is started here."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "device_mesh needs an initialized torch.distributed process "
            "group: call init_process_group(backend, init_method=..., "
            "world_size=W, rank=r) in every rank first")
    if shape.size() != dist.get_world_size():
        raise ValueError(f"a {describe(shape)} mesh needs {shape.size()} "
                         f"ranks, the group has {dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    return init_device_mesh(device_type, tuple(shape.sizes),
                            mesh_dim_names=tuple(shape.axis_names))


def mesh_shape(mesh) -> MeshShape:
    """The `MeshShape` of a `DeviceMesh` (or of a `MeshShape`)."""
    names: Sequence[str] = mesh.mesh_dim_names or ()
    return MeshShape(tuple(names), tuple(mesh.size(i)
                                         for i in range(len(names))))


def describe(mesh) -> str:
    shape = mesh_shape(mesh)
    return "x".join(f"{n}:{s}" for n, s in zip(shape.axis_names,
                                               shape.sizes))
