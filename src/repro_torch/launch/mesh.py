"""Mesh factories.

Counterpart of the JAX package's ``launch/mesh.py``.  A mesh names the
axes of a set of cards and their sizes.  Two kinds serve the port:

* ``AbstractMesh``: names and sizes only, no process group, like jax's
  ``AbstractMesh``.  ``make_production_mesh`` and ``make_host_mesh``
  return one, and building it touches no device and no process group.
  A plan priced for it runs the ``static_tp`` route, which computes
  every shard's partial on the one card it runs on.
* ``torch.distributed.device_mesh.DeviceMesh``, the concrete mesh over
  an initialised process group (``make_device_mesh``): the
  ``static_tp_shardmap`` route runs one shard per rank on it and sums
  the partials over the group of its ``tp_axis``.

``mesh_axes`` reads the axis names and sizes of either kind.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, with no devices behind them."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        object.__setattr__(self, "axis_sizes",
                           tuple(int(s) for s in self.axis_sizes))
        object.__setattr__(self, "axis_names",
                           tuple(str(n) for n in self.axis_names))
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.axis_sizes} and names "
                             f"{self.axis_names} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axis names repeat: {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """``(axis names, axis sizes)`` of an ``AbstractMesh`` or a
    ``DeviceMesh`` (``((), ())`` for None)."""
    if mesh is None:
        return (), ()
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names, mesh.axis_sizes
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError("a DeviceMesh used for planning needs "
                         "mesh_dim_names (make_device_mesh names them)")
    return (tuple(str(n) for n in names),
            tuple(int(mesh.size(i)) for i in range(len(names))))


def is_concrete(mesh) -> bool:
    """Is ``mesh`` a ``DeviceMesh`` over a process group (not abstract)?"""
    if mesh is None or isinstance(mesh, AbstractMesh):
        return False
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production mesh, abstract: 16 x 16 ``("data",
    "model")``, or 2 x 16 x 16 with a ``"pod"`` axis."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_host_mesh() -> AbstractMesh:
    """One card: ``("data", "model")`` axes of size 1."""
    return AbstractMesh((1, 1), ("data", "model"))


def make_device_mesh(device_type: str, shape: Sequence[int],
                     axis_names: Sequence[str]):
    """A ``DeviceMesh`` of ``device_type`` ("cuda" or "cpu") over the
    initialised default process group, whose world size must be the
    product of ``shape``.  Every rank calls it, with the same
    arguments."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise ValueError("make_device_mesh needs an initialised process "
                         "group (torch.distributed.init_process_group)")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axis_names))
