"""Named-axis sharding rules: parameter names -> PartitionSpec.

Counterpart of the JAX package's ``sharding/rules.py``, whose strategy
it keeps:

* weights: TP axis over ``model`` (heads / d_ff / experts / vocab) and an
  FSDP axis over ``data`` on the other large dim where divisible --
  optimizer state inherits the same specs, so Adam moments are spread
  over data*model cards;
* weights are replicated over ``pod``; gradients all-reduce across pods;
* activations: batch over ('pod', 'data'); KV cache sequence over
  'model'; batch-1 long context shards sequence over ('data', 'model').

Divisibility fallback: any dim not divisible by its axis product is left
unsharded (replicated on that axis), so one rule set serves all ten
architectures.

The rules read a mesh's axis names and sizes through
``launch.mesh.mesh_axes``, so they take the port's ``AbstractMesh`` and a
``DeviceMesh`` alike.  ``PartitionSpec`` is the port's own: per dim an
axis name, a tuple of names, or None.

Paths.  The reference matches its rules against the key path of a leaf
of its parameter tree (``['stack'][0][1]['attn']['wq']['w']``).  A port
parameter's name is that path's keys joined by dots, with the stacked
``[repeat, ...]`` layer axis unstacked into per-layer modules
(``layers.3.attn.wq.w``; ``LM.jax_leaves`` holds the same map), and
every rule is anchored at the path's tail, so ``ref_path`` writes a
name in the reference's notation and the rules match it unchanged.  A
port tensor lacks the stacking dim; ``_spec`` leaves that leading dim
None in the reference, so a port spec is the reference leaf's spec
without it.

``held_spec`` is a parameter's whole spec: the block a rank of an LM
on a concrete mesh holds (``models/``; FSDP: the ``"data"`` split
beside the ``"model"`` one), gathered over ``"data"`` where a module
uses it (``core.tp.gather_held``); its optimizer state is that block
(``train/step.py``).  A mixer whose heads do not split holds the
``"data"`` part only (``held_block(model=False)``).
``mla_held_blocks`` and ``ssm_held_blocks`` are the blocks of an MLA and
a Mamba-2 mixer's rank (the latter's in projection and conv a block no
rule gives: its heads' columns beside those every head reads).

``constrain`` (a GSPMD layout hint on an activation) is not ported: the
port runs eagerly, one program per rank, so there is nothing for a hint
to steer.  ``current_mesh`` is read by the MoE layer's expert-parallel
route (``models/moe.py``).
"""
from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Dict, List, Sequence, Tuple

from repro_torch.launch.mesh import mesh_axes


class PartitionSpec(tuple):
    """Per dim: an axis name, a tuple of axis names, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _shape(mesh) -> Dict[str, int]:
    names, sizes = mesh_axes(mesh)
    return dict(zip(names, sizes))


def _axis_size(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    shape = _shape(mesh)
    s = 1
    for n in names:
        s *= shape[n]
    return s


def batch_axes(mesh) -> Tuple[str, ...]:
    names = mesh_axes(mesh)[0]
    return tuple(a for a in ("pod", "data") if a in names)


def _fit(mesh, dim: int, names):
    """Return ``names`` if dim divides by their product, else None."""
    if isinstance(names, str):
        names = (names,)
    axes = mesh_axes(mesh)[0]
    names = tuple(n for n in names if n in axes)
    if not names:
        return None
    return names if dim % _axis_size(mesh, names) == 0 else None


def _spec(mesh, shape, base_ndim, last_dims) -> PartitionSpec:
    """PartitionSpec: leading (stacking) dims None, trailing per rule.

    ``last_dims``: tuple of axis-name-or-None for the final ``base_ndim``
    dims, each checked for divisibility.
    """
    lead = len(shape) - base_ndim
    spec = [None] * lead
    for d, names in zip(shape[lead:], last_dims):
        fit = _fit(mesh, d, names) if names else None
        if fit is None:
            spec.append(None)
        else:
            spec.append(fit if len(fit) > 1 else fit[0])
    return P(*spec)


# -- the mesh the step runs under ------------------------------------------------

_ACT_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_activation_mesh", default=(None, True))


@contextlib.contextmanager
def activation_mesh(mesh, *, batch_split: bool = True):
    """Install ``mesh`` for the layers that read it (the MoE routes).
    ``batch_split``: the tokens a rank holds are its shard of the batch
    over the mesh's batch axes (the train step's layout); False: every
    rank holds the whole batch (the serving engine's ranks)."""
    tok = _ACT_MESH.set((mesh, bool(batch_split)))
    try:
        yield
    finally:
        _ACT_MESH.reset(tok)


def current_mesh():
    """The mesh installed by ``activation_mesh`` (None outside)."""
    return _ACT_MESH.get()[0]


def batch_split() -> bool:
    """Was the installed mesh installed with ``batch_split``?"""
    return _ACT_MESH.get()[1]


def token_axes(mesh) -> Tuple[str, ...]:
    """The axes of ``mesh`` (the installed one) that split the tokens: its
    batch axes, or none when it was installed without ``batch_split``."""
    return batch_axes(mesh) if batch_split() else ()


# -- parameter rules ---------------------------------------------------------

_PARAM_RULES = [
    # (path regex, base_ndim, last-dim axes)
    (r"\['table'\]$",                2, ("model", "data")),
    (r"\['(wq|wk|wv)'\]\['w'\]$",    2, ("data", "model")),
    (r"\['(wq|wk|wv)'\]\['b'\]$",    1, ("model",)),
    (r"\['wo'\]\['w'\]$",            2, ("model", "data")),
    (r"\['q'\]\['a'\]\['w'\]$",      2, ("data", None)),
    (r"\['q'\]\['b'\]\['w'\]$",      2, (None, "model")),
    (r"\['q'\]\['w'\]\['w'\]$",      2, ("data", "model")),
    (r"\['kv_a'\]\['w'\]$",          2, ("data", None)),
    (r"\['kv_b'\]\['w'\]$",          2, (None, "model")),
    (r"\['(up|gate)'\]\['w'\]$",     2, ("data", "model")),
    (r"\['(up|gate)'\]\['b'\]$",     1, ("model",)),
    (r"\['down'\]\['w'\]$",          2, ("model", "data")),
    (r"\['down'\]\['b'\]$",          1, (None,)),
    (r"\['(w_gate|w_up)'\]$",        3, ("model", "data", None)),
    (r"\['w_down'\]$",               3, ("model", "data", None)),
    (r"\['router'\]",                2, (None, None)),
    (r"\['in_proj'\]\['w'\]$",       2, ("data", None)),
    (r"\['out_proj'\]\['w'\]$",      2, ("model", "data")),
    (r"\['values'\]$",               3, ("model", None, None)),  # BSR blocks
]


def ref_path(name: str) -> str:
    """A port parameter name (``layers.3.attn.wq.w``) in the reference's
    key-path notation (``['layers'][3]['attn']['wq']['w']``)."""
    return "".join(f"[{k}]" if k.isdigit() else f"['{k}']"
                   for k in name.split("."))


def _param_spec_for(mesh, path_str: str, shape) -> PartitionSpec:
    for pat, base, dims in _PARAM_RULES:
        if re.search(pat, path_str):
            return _spec(mesh, shape, base, dims)
    if len(shape) >= 2 and shape[-1] >= 128 and shape[-2] >= 128:
        return _spec(mesh, shape, 2, ("data", "model"))  # generic 2D weight
    return P()  # norms, scalars, biases: replicated


def param_spec(name: str, shape: Sequence[int], mesh) -> PartitionSpec:
    """The spec of the parameter ``name`` of (whole) ``shape``."""
    return _param_spec_for(mesh, ref_path(name), tuple(shape))


def held_spec(name: str, shape: Sequence[int], mesh) -> PartitionSpec:
    """The block of ``name`` a rank of an LM on a concrete mesh holds:
    its whole ``param_spec``, the ``"data"`` split (FSDP) beside the
    ``"model"`` one."""
    return param_spec(name, shape, mesh)


def data_split(spec, mesh):
    """``launch.mesh.DataSplit`` of a parameter held under ``spec``: the
    dim its ``"data"`` entry splits on a concrete mesh whose ``"data"``
    axis is past 1; else None."""
    from repro_torch.launch.mesh import (DataSplit, axes_group, axis_index,
                                         is_concrete)
    if not is_concrete(mesh):
        return None
    for d, e in enumerate(spec):
        if e == "data":
            idx, n = axis_index(mesh, ("data",))
            return (DataSplit(d, axes_group(mesh, ("data",)), idx, n)
                    if n > 1 else None)
    return None


def held_block(name: str, shape: Sequence[int], mesh, *,
               model: bool = True):
    """``launch.mesh.Held`` of a parameter held as its ``held_spec``
    block, the optimizer state that block itself.  ``model=False`` (a
    mixer whose heads do not split runs whole over ``"model"``): the
    block is the spec's ``"data"`` part only, the state the spec's whole
    block inside it."""
    from repro_torch.launch.mesh import Block, Held, block_slices
    spec = param_spec(name, shape, mesh)
    data = data_split(spec, mesh)
    if model:
        return Held.whole(Block.of(shape, spec, mesh), data=data)
    blk = Block.of(shape, P(*(None if e == "model" else e for e in spec)),
                   mesh)
    local = block_slices(blk.block_shape,
                         P(*(e if e == "model" else None for e in spec)),
                         mesh)
    return Held(blk, Block.of(shape, spec, mesh), local, data=data)


def hold(name: str, shape: Sequence[int], mesh, *, model: bool):
    """``held_block`` of a module's parameter, or None where the rank
    holds it whole: ``model`` (the module splits over ``"model"``)
    always holds a block; otherwise only a ``"data"`` split does."""
    if model:
        return held_block(name, shape, mesh)
    h = held_block(name, shape, mesh, model=False)
    return h if h.data is not None else None


def with_data(name: str, held, mesh, *, first: bool = True):
    """``held`` (a block of the port's own over ``"model"``, whole on
    its other dims: KV heads several ranks read) narrowed to the rule's
    ``"data"`` split as well; its owner then the ``first`` of the ranks
    holding the same rows (index 0 along the axes neither splits)."""
    from repro_torch.launch.mesh import Block, Held, block_slices, owns_block
    blk = held.block
    spec = param_spec(name, blk.shape, mesh)
    data = data_split(spec, mesh)
    if data is None:
        return held
    index = list(blk.index)
    index[data.dim] = block_slices(blk.shape, spec, mesh)[data.dim]
    owner = first and owns_block(mesh, P("data", "model"))
    return Held.whole(Block(blk.shape, tuple(index), owner,
                            tuple(blk.axes) + ("data",), blk.write),
                      partial=held.partial, data=data)


def mla_held_blocks(cfg, mesh, *, model: bool = True) -> Dict[str, dict]:
    """The blocks an MLA mixer's rank holds (by module name; ``hold``'s:
    a None entry is held whole).  ``model`` (the ``"model"`` axis's m
    ranks divide its heads): the rules' ``"model"`` parts, its heads'
    columns of the query's ``q.b.w`` (or ``q.w.w``) and of ``kv_b.w``,
    its heads' rows of ``wo.w`` -- heads are contiguous column (row)
    ranges of each, so a rule's block holds whole heads.  Beside them,
    and on their own where the heads do not split, the rules' ``"data"``
    parts (FSDP), ``q.a.w`` and ``kv_a.w`` among them."""
    d, h = cfg.d_model, cfg.num_heads
    qd = h * (cfg.qk_nope_dim + cfg.qk_rope_dim)
    r = cfg.kv_lora_rank

    def blk(name, shape, split=model):
        return {"w": hold(name, shape, mesh, model=split)}
    held = {"kv_a": blk("kv_a.w", (d, r + cfg.qk_rope_dim), False),
            "kv_b": blk("kv_b.w", (r, h * (cfg.qk_nope_dim
                                           + cfg.v_head_dim))),
            "wo": blk("wo.w", (h * cfg.v_head_dim, d))}
    if cfg.q_lora_rank:
        held["q.a"] = blk("q.a.w", (d, cfg.q_lora_rank), False)
        held["q.b"] = blk("q.b.w", (cfg.q_lora_rank, qd))
    else:
        held["q.w"] = blk("q.w.w", (d, qd))
    return held


def ssm_held_blocks(cfg, mesh, h0: int, hl: int) -> Dict[str, object]:
    """The blocks a Mamba-2 mixer's rank holds for its heads ``[h0, h0 +
    hl)`` of ``H`` (by parameter name; ``launch.mesh.Held``):

    * ``out_proj.w``: its heads' rows (the rule's ``"model"`` block);
    * ``in_proj.w``: its heads' ``z`` and ``x`` columns, and every
      ``B``, ``C`` and ``dt`` column.  ``B`` and ``C`` are read by every
      head (one group); ``dt`` is every head's too, so that the block's
      width keeps the whole's residue mod 8 (the dense_mm kernel's TMA
      needs widths that are multiples of 8: mamba2-130m at m = 2 holds
      1816 columns, not 1804).  A block no rule gives (the reference's
      rule leaves ``in_proj`` whole over ``"model"``); the columns
      every rank holds have partial gradients and are written back by
      the ``"model"`` axis's first rank only (``Block.write``);
    * ``conv_w`` / ``conv_b``: its ``x`` channels and every ``B`` /
      ``C`` channel, likewise;
    * ``dt_bias``, ``A_log``, ``D`` and the gated norm's ``norm.scale``:
      its heads (its heads' ``d_inner`` channels).

    The optimizer state of each block is the whole block; ``in_proj``'s
    rows are split over ``"data"`` as its rule splits them (FSDP)."""
    import numpy as np

    from repro_torch.launch.mesh import Block, Held, axis_index, owns_block
    s = cfg.ssm
    d = cfg.d_model
    di, nh, p = s.d_inner(d), s.num_heads(d), s.head_dim
    gn = s.n_groups * s.d_state
    in_dim, conv_dim = 2 * di + 2 * gn + nh, di + 2 * gn
    data = data_split(param_spec("in_proj.w", (d, in_dim), mesh), mesh)
    first = axis_index(mesh, ("model",))[0] == 0
    z = np.arange(h0 * p, (h0 + hl) * p, dtype=np.int64)
    own_in = np.concatenate([z, di + z])
    cols = np.concatenate([own_in, np.arange(2 * di, in_dim)])
    chans = np.concatenate([z, np.arange(di, conv_dim)])

    def shared(shape, idx, own, rows=None):
        """A block of ``idx`` on the last dim (and of ``rows``, the
        ``"data"`` split's, on the first), of which this rank writes
        back ``own`` (its first ``len(own)`` entries) unless it is the
        ``"model"`` axis's first rank (which writes all of it)."""
        lead = (slice(None),) * (len(shape) - 1)
        at = lead if rows is None else (rows,)
        write = None if first else (
            at + (own,), lead + (np.arange(len(own), dtype=np.int64),))
        # the rank of its rows (index 0 along the axes the block does not
        # split) writes it back
        owner = owns_block(mesh, P("model") if rows is None else
                           P("data", "model"))
        return Held.whole(Block(tuple(shape), at + (idx,), owner,
                                ("model",) if rows is None else
                                ("model", "data"), write),
                          partial=True, data=None if rows is None else data)

    rows = None if data is None else Block.of(
        (d, in_dim), P("data", None), mesh).index[0]

    def heads(n):
        return Held.whole(Block.of((n,), P("model"), mesh))
    return {"in_proj.w": shared((d, in_dim), cols, own_in, rows),
            "conv_w": shared((s.d_conv, conv_dim), chans, z),
            "conv_b": shared((conv_dim,), chans, z),
            "dt_bias": heads(nh), "A_log": heads(nh), "D": heads(nh),
            "norm.scale": heads(di),
            "out_proj.w": held_block("out_proj.w", (di, d), mesh)}


def model_split(mesh) -> int:
    """The size of ``mesh``'s ``"model"`` axis when it is concrete, else
    1: an LM built on a mesh splits over that axis when it is past 1."""
    from repro_torch.launch.mesh import is_concrete
    names, sizes = mesh_axes(mesh)
    if not is_concrete(mesh) or "model" not in names:
        return 1
    return sizes[names.index("model")]


def _shape_of(leaf) -> tuple:
    """A tensor's (or a meta tensor's) shape, or a shape given as one."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def param_specs(params: Dict[str, object], mesh) -> Dict[str, PartitionSpec]:
    """``{name: PartitionSpec}`` for ``{name: tensor or shape}`` (a meta
    tensor or a shape will do: nothing is read)."""
    return {n: param_spec(n, _shape_of(p), mesh) for n, p in params.items()}


# -- train state --------------------------------------------------------------

def train_state_specs(tree: dict, mesh) -> dict:
    """The specs of a ``train.step.state_tree`` of whole tensors (or
    shapes): params, the fp32 master, the moments and the compression
    residuals share each parameter's spec; the step and the count (0-dim)
    are replicated."""
    out = {}
    for key, node in tree.items():
        if key == "params":
            out[key] = param_specs(node, mesh)
        elif isinstance(node, dict):
            out[key] = {k: (param_specs(v, mesh)
                            if k in ("master", "mu", "nu", "residual")
                            else P()) for k, v in node.items()}
        else:
            out[key] = P()
    return out


def train_batch_specs(batch: dict, mesh) -> Dict[str, PartitionSpec]:
    """Batch entries: the leading (batch) dim over the batch axes where
    it divides by their product, the rest replicated."""
    ba = batch_axes(mesh)

    def f(leaf):
        shape = _shape_of(leaf)
        if not shape:
            return P()
        fit = _fit(mesh, shape[0], ba)
        first = (fit if fit and len(fit) > 1 else
                 (fit[0] if fit else None))
        return P(first, *([None] * (len(shape) - 1)))
    return {k: f(v) for k, v in batch.items()}


# -- caches --------------------------------------------------------------------

def cache_specs(caches: Sequence[dict], mesh, *, batch: int
                ) -> List[Dict[str, PartitionSpec]]:
    """KV / state caches, one dict per layer (``LM.init_cache``), each
    leaf ``[B, S, ...]`` (the reference's ``[L, B, S, ...]`` without its
    stacked layer axis; the spec is the reference's without that dim).

    batch >= |pod|*|data|  -> B over ('pod','data'), S over 'model';
    batch == 1 (long ctx)  -> S over ('data','model') (+'pod' if present).
    """
    ba = batch_axes(mesh)
    axes = mesh_axes(mesh)[0]
    b_fit = batch % _axis_size(mesh, ba) == 0 if ba else False
    seq_axes = ("model",) if b_fit else tuple(
        a for a in ("pod", "data", "model") if a in axes)

    def f(key, leaf):
        # the reference's rule on [1, B, S, ...], its stacked axis dropped
        shape = (1,) + _shape_of(leaf)
        spec = [None] * len(shape)
        if len(shape) >= 2 and shape[1] == batch and b_fit:
            spec[1] = ba if len(ba) > 1 else ba[0]
        if key in ("k", "v", "latent", "k_rope", "xk", "xv") \
                and len(shape) >= 3:
            fit = _fit(mesh, shape[2], seq_axes)
            if fit:
                spec[2] = fit if len(fit) > 1 else fit[0]
        elif key == "state" and len(shape) >= 3:
            fit = _fit(mesh, shape[2], "model")   # heads
            if fit:
                spec[2] = fit[0]
        return P(*spec[1:])
    return [{k: f(k, v) for k, v in c.items()} for c in caches]
