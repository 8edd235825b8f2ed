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

``mesh_axes`` reads the axis names and sizes of either kind.  The
helpers below it serve the data-parallel step (``train/step.py``), the
checkpoint's re-sharding and the MoE layer's expert-parallel route over
a ``DeviceMesh``: a rank's index along a set of axes, the process group
of a set of axes, and the block of a tensor that a ``PartitionSpec``
gives a rank (an entry of several axes orders them first-major, as the
reference's specs do).  On an abstract mesh, or without one, a rank's
block is the whole tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple


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


# -- a rank's place on a concrete mesh ------------------------------------------

def spec_axes(spec) -> Tuple[str, ...]:
    """The mesh axes a ``PartitionSpec`` shards over, in its order."""
    out = []
    for e in spec:
        if e is not None:
            out += [e] if isinstance(e, str) else list(e)
    return tuple(out)


def axis_index(mesh, names: Sequence[str]) -> Tuple[int, int]:
    """``(this rank's index along the product of axes names, its size)``
    (the first name most significant); ``(0, 1)`` off a concrete
    mesh."""
    if not is_concrete(mesh):
        return 0, 1
    axes, sizes = mesh_axes(mesh)
    coord = mesh.get_coordinate()
    idx, size = 0, 1
    for n in names:
        i = axes.index(n)
        idx, size = idx * sizes[i] + int(coord[i]), size * sizes[i]
    return idx, size


def block_slices(shape: Sequence[int], spec, mesh) -> Tuple[slice, ...]:
    """The slices of a tensor of ``shape`` that ``spec`` gives this rank
    (every dim a sharded entry splits must divide by its axes' size, as
    the rules' divisibility fallback ensures)."""
    out = []
    for d, dim in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        if e is None:
            out.append(slice(None))
            continue
        idx, n = axis_index(mesh, (e,) if isinstance(e, str) else e)
        if dim % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {e} ({n} ways)")
        out.append(slice(idx * (dim // n), (idx + 1) * (dim // n)))
    return tuple(out)


def block(t, spec, mesh):
    """This rank's block of ``t`` under ``spec`` (a view)."""
    return t[block_slices(t.shape, spec, mesh)]


def block_shape(shape: Sequence[int], spec, mesh) -> Tuple[int, ...]:
    return tuple(len(range(*s.indices(d)))
                 for s, d in zip(block_slices(shape, spec, mesh), shape))


def owns_block(mesh, spec) -> bool:
    """Is this rank the one of its block's replicas that writes it back
    (index 0 along every axis ``spec`` leaves replicated)?"""
    if not is_concrete(mesh):
        return True
    used = set(spec_axes(spec))
    rest = [n for n in mesh_axes(mesh)[0] if n not in used]
    return axis_index(mesh, rest)[0] == 0


def gather_block(t, shape: Sequence[int], spec, mesh):
    """The whole tensor of ``shape`` from every rank's block ``t`` under
    ``spec``: zeros beside the block's one writer (``owns_block``),
    all-reduced over the whole mesh (one collective for every backend:
    gloo reduces card tensors but does not gather them).  Every rank
    calls it."""
    import torch.distributed as dist
    whole = t.new_zeros(tuple(shape))
    if owns_block(mesh, spec):
        block(whole, spec, mesh).copy_(t)
    group = axes_group(mesh, mesh_axes(mesh)[0])
    if group is not None:
        dist.all_reduce(whole, group=group)
    return whole


def axes_group(mesh, names: Sequence[str]):
    """The process group of this rank's replicas along axes ``names``
    (the ranks that differ from it only there); None when the axes'
    product is 1.  One axis is the mesh's own group; a set of axes is
    made once per mesh (``new_subgroups_by_enumeration``: every rank
    must ask for the same sets in the same order, as ranks running one
    program do)."""
    import torch.distributed as dist
    axes, sizes = mesh_axes(mesh)
    names = tuple(n for n in axes if n in names)
    if axis_index(mesh, names)[1] == 1:
        return None
    if len(names) == 1:
        return mesh.get_group(names[0])
    cache: Dict[tuple, object] = mesh.__dict__.setdefault(
        "_repro_axes_groups", {})
    if names not in cache:
        grid = mesh.mesh.permute(
            *[axes.index(n) for n in axes if n not in names],
            *[axes.index(n) for n in names])
        lists = grid.reshape(-1, axis_index(mesh, names)[1]).tolist()
        cache[names] = dist.new_subgroups_by_enumeration(lists)[0]
    return cache[names]


def group_size(group: Optional[object]) -> int:
    import torch.distributed as dist
    return 1 if group is None else dist.get_world_size(group)
