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
reference's specs do) or that a model-parallel LM holds (``Block``),
and the seeded draw that fills such a block (``fill_normal``).  On an
abstract mesh, or without one, a rank's block is the whole tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np


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
    ``spec`` (``Block.gather``: the block's one writer, ``owns_block``,
    writes it).  Every rank calls it."""
    return Block.of(shape, spec, mesh).gather(t, mesh)


def _index_key(index, like):
    """``index`` (slices, and int64 arrays) as a key into ``like``."""
    if isinstance(like, np.ndarray):
        return tuple(index)
    import torch
    return tuple(ix if isinstance(ix, slice) else
                 torch.as_tensor(ix, dtype=torch.long, device=like.device)
                 for ix in index)


@dataclasses.dataclass(frozen=True, eq=False)
class Block:
    """The part of a tensor of whole ``shape`` that a rank holds:
    ``index`` per dim is a slice, or (one dim at most) an int64 array of
    the rows it holds, in its order; ``owner``: this rank is the one of
    the block's replicas that writes it back; ``axes``: the mesh axes
    along which ranks hold different blocks.  A ``PartitionSpec``'s
    block is ``Block.of(shape, spec, mesh)``; a model-parallel LM also
    holds blocks no spec gives (a k-shard's blocks of a sparse FFN, the
    KV heads a rank's query heads read, a Mamba-2 rank's heads' columns
    of its in projection beside the columns every head reads).
    ``write``: where several ranks' blocks overlap in part, the part an
    owner writes back, ``(its index in the whole tensor, its index in
    the block)``; None: the whole block."""

    shape: Tuple[int, ...]
    index: tuple
    owner: bool = True
    axes: Tuple[str, ...] = ()
    write: Optional[tuple] = None

    @classmethod
    def of(cls, shape: Sequence[int], spec, mesh) -> "Block":
        return cls(tuple(shape), block_slices(shape, spec, mesh),
                   owns_block(mesh, spec), spec_axes(spec))

    @classmethod
    def whole(cls, shape: Sequence[int], mesh) -> "Block":
        return cls.of(shape, (), mesh)

    @property
    def block_shape(self) -> Tuple[int, ...]:
        return tuple(len(ix) if not isinstance(ix, slice)
                     else len(range(*ix.indices(d)))
                     for ix, d in zip(self.index, self.shape))

    def _key(self, like):
        return _index_key(self.index, like)

    def whole_on(self, dim: int) -> "Block":
        """This block whole along ``dim`` (its ``"data"`` split gathered:
        ``LM.gather_data``)."""
        def widen(index):
            return tuple(slice(None) if d == dim else ix
                         for d, ix in enumerate(index))
        return Block(self.shape, widen(self.index), self.owner,
                     tuple(a for a in self.axes if a != "data"),
                     None if self.write is None else
                     tuple(widen(w) for w in self.write))

    def take(self, t):
        """This block of the whole ``t`` (a tensor or an array)."""
        return t[self._key(t)]

    def put(self, whole, blk) -> None:
        """Write ``blk`` into its place in ``whole``."""
        whole[self._key(whole)] = blk

    def written(self, blk):
        """The part of the held ``blk`` an owner writes back."""
        if self.write is None:
            return blk
        return blk[_index_key(self.write[1], blk)]

    def gather(self, t, mesh):
        """The whole tensor from every rank's block ``t`` (every rank
        calls it): each block's writers write their ``written`` part.
        Where the backend gathers ``t`` (``gathers``), the writers' parts
        are all-gathered with where each goes (``_gather_parts``); a card
        tensor over gloo is all-reduced instead, zeros beside the
        writers' parts."""
        import torch.distributed as dist
        group = axes_group(mesh, mesh_axes(mesh)[0])
        if group is not None and gathers(group, t):
            return self._gather_parts(t, group)
        whole = t.new_zeros(self.shape)
        if self.owner and self.write is not None:
            whole[_index_key(self.write[0], whole)] = self.written(t)
        elif self.owner:
            self.put(whole, t)
        if group is not None:
            dist.all_reduce(whole, group=group)
        return whole

    def _gather_parts(self, t, group):
        """``gather`` by two all-gathers over ``group``: each rank's
        written part's place (per dim, its indices in the whole tensor
        and in the block, padded to the dim's length), then the parts,
        flat and padded to the largest; every rank writes every part."""
        import torch
        import torch.distributed as dist
        nd, dev = len(self.shape), t.device

        def arange(ix, n):
            if isinstance(ix, slice):
                return np.arange(*ix.indices(n), dtype=np.int64)
            return np.asarray(ix, dtype=np.int64)
        dst, src = (self.write if self.write is not None else
                    (self.index, (slice(None),) * nd))
        meta = []
        for d, n in enumerate(self.shape):
            a = arange(dst[d], n) if self.owner else np.zeros(0, np.int64)
            b = arange(src[d], t.shape[d]) if self.owner else a
            meta += [[len(a)], np.pad(a, (0, n - len(a))),
                     np.pad(b, (0, n - len(b)))]
        meta = torch.as_tensor(np.concatenate(meta), device=dev)
        world = dist.get_world_size(group)
        metas = meta.new_empty(world * meta.numel())
        dist.all_gather_into_tensor(metas, meta, group=group)
        metas = metas.view(world, -1).cpu().numpy()

        def parts(row):
            out, off = [], 0
            for n in self.shape:
                k = int(row[off])
                out.append((row[off + 1:off + 1 + k],
                            row[off + 1 + n:off + 1 + n + k]))
                off += 1 + 2 * n
            return out
        ranks = [parts(row) for row in metas]
        sizes = [int(np.prod([len(a) for a, _ in r])) for r in ranks]
        me = dist.get_rank(group)
        flat = t.new_zeros(max(sizes))
        if sizes[me]:
            flat[:sizes[me]] = t[_outer([b for _, b in ranks[me]],
                                        dev)].reshape(-1)
        flats = flat.new_empty(world * flat.numel())
        dist.all_gather_into_tensor(flats, flat, group=group)
        flats = flats.view(world, -1)
        whole = t.new_zeros(self.shape)
        for r, part in enumerate(ranks):
            if sizes[r]:
                whole[_outer([a for a, _ in part], dev)] = flats[
                    r, :sizes[r]].reshape([len(a) for a, _ in part])
        return whole


def _outer(index, device):
    """Per-dim index arrays as a broadcast (outer-product) key."""
    import torch
    nd = len(index)
    return tuple(torch.as_tensor(ix, dtype=torch.long, device=device).view(
        [-1 if i == d else 1 for i in range(nd)])
        for d, ix in enumerate(index))


def gathers(group, t) -> bool:
    """Does ``group``'s backend all-gather and reduce-scatter ``t``?  All
    do but gloo for a card tensor (gloo reduces card tensors, it does
    not gather them): there an all-reduce of zeros beside each rank's
    part stands in, moving about twice the bytes."""
    import torch.distributed as dist
    return not (t.is_cuda and dist.get_backend(group) == "gloo")


@dataclasses.dataclass(frozen=True, eq=False)
class DataSplit:
    """A parameter held split on ``dim`` over the mesh's ``"data"`` axis
    (FSDP): ``group`` that axis's process group, ``idx`` this rank's
    part of ``n``."""

    dim: int
    group: object
    idx: int
    n: int


@dataclasses.dataclass(frozen=True, eq=False)
class Held:
    """A parameter a rank holds as ``block`` of its whole tensor; the
    optimizer state's block of it is ``state`` (its place in the whole
    tensor) and ``local`` (its slices of the held block); ``partial``:
    the gradient each rank computes for the block is a partial sum, to
    be summed over every rank that holds it (a norm inside split heads,
    KV heads several ranks' query heads read); ``data``: the block is
    split over ``"data"`` as well (FSDP), and its module gathers that
    split where it uses the weight (``core.tp.gather_held``)."""

    block: Block
    state: Block
    local: tuple
    partial: bool = False
    data: Optional[DataSplit] = None

    @classmethod
    def whole(cls, block: Block, *, partial: bool = False,
              data: Optional[DataSplit] = None) -> "Held":
        """The state is the whole held block."""
        return cls(block, block, (slice(None),) * len(block.shape),
                   partial, data)


# one draw of a seeded fill covers at most this many elements (1 GiB of
# fp32 on the card); a tensor up to this size is drawn in one piece, as
# before model parallelism, so a one-process model's numbers are those
# of a single draw wherever the tensor is not larger (only the
# vocabulary tables past 2^28 elements, qwen's, gemma2's and glm4's, are
# drawn in pieces)
DRAW_ELEMS = 1 << 28


def fill_normal(p, generator, scale: Callable,
                held: Optional["Held"] = None) -> None:
    """Fill ``p`` with ``scale(N(0, 1))`` drawn from ``generator`` in
    pieces of rows along dim 0 (one piece up to ``DRAW_ELEMS``
    elements); with ``held``, ``p`` is its block of the whole tensor, the
    draws are the whole tensor's and ``p`` keeps its part of every
    piece.  The draws depend on the whole shape only, so a block holds
    what the whole tensor holds there."""
    import torch
    block = None if held is None else held.block
    shape = tuple(p.shape if block is None else block.shape)
    row = int(np.prod(shape[1:], dtype=np.int64))
    rows = shape[0] if row * shape[0] <= DRAW_ELEMS else \
        max(1, DRAW_ELEMS // max(row, 1))
    idx0 = None if block is None else block.index[0]
    rest = () if block is None else tuple(block.index[1:])
    with torch.no_grad():
        for r0 in range(0, shape[0], rows):
            r1 = min(r0 + rows, shape[0])
            piece = torch.randn((r1 - r0,) + shape[1:], generator=generator,
                                device=p.device)
            if block is None:
                p[r0:r1].copy_(scale(piece))
            elif isinstance(idx0, slice):
                lo, hi, _ = idx0.indices(shape[0])
                a, b = max(r0, lo), min(r1, hi)
                if a < b:
                    p[a - lo:b - lo].copy_(
                        scale(piece[(slice(a - r0, b - r0),) + rest]))
            else:
                mine = torch.as_tensor(idx0, dtype=torch.long,
                                       device=p.device)
                sel = (mine >= r0) & (mine < r1)
                if bool(sel.any()):
                    p[sel] = scale(piece[(mine[sel] - r0,) + rest]).to(
                        p.dtype)


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
