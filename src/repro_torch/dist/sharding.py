"""Sharding vocabulary shared by models, bundles, and the launch layer (the
port of ``repro/dist/sharding.py``).

Everything here is mesh-OPTIONAL: on a single device (unit tests, smoke
configs) ``ambient_mesh()`` is None and every helper returns its argument
unchanged, so model code can sprinkle sharding hints unconditionally.
Inside ``with use_mesh(mesh):`` (the counterpart of the reference's ``with
mesh:``) the same hints act on rank-local tensors.

Conventions (mirrors launch/mesh.py):
  * batch/data parallelism lives on the ``data`` axis (plus ``pod`` when the
    multi-pod mesh is in play) — ``batch_axes(mesh)`` resolves the tuple;
  * tensor/expert parallelism lives on the ``model`` axis;
  * LM parameter stacks carry a leading layer axis which is ZeRO-sharded over
    the batch axes; ``make_constrain`` in families.py drops that leading entry
    to state the per-layer (model-axis) sharding of one gathered layer.

**The vocabulary.**  ``P`` is a tuple of entries (an axis name, a tuple of
names, or None), as JAX's ``PartitionSpec``; :class:`Mesh` names the axis
sizes (``AbstractMesh`` for spec arithmetic with no ranks behind it, or a
``torch.distributed`` ``DeviceMesh`` wrapped by :func:`as_mesh`);
:class:`NamedSharding` pairs the two, with ``shard_shape`` (raising where
JAX's raises: a dimension its axes do not divide) and the
``torch.distributed.tensor`` placements per mesh dim.

**The manual path.**  PyTorch has no eager GSPMD, so the mesh path runs on
rank-local tensors with explicit collectives (``dist.spmd``).  Every
activation there is held batch-local from the step's inputs on (the rank's
rows of the batch, as the bundles' ``shardings`` place the inputs): an
entry that names only batch axes names what the rank already holds.  Any
other entry that resolves onto the mesh cuts the tensor to the rank's
block along that dim (the backward all-gathers), and
:func:`unshard_activation` puts the whole dim back.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch


class P(tuple):
    """A partition spec: one entry per leading tensor dim (an axis name, a
    tuple of axis names, or None); missing trailing entries replicate."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P(" + ", ".join(repr(e) for e in self) + ")"


# ------------------------------------------------------------------ meshes
class Mesh:
    """Named mesh axes (``shape``: name -> size, in mesh order); with a
    ``device_mesh`` (``torch.distributed.device_mesh.DeviceMesh``) it also
    knows this rank's coordinates and the process group of each set of
    axes."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device_mesh=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axis names "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        self.device_mesh = device_mesh
        self._groups: Dict[Tuple[str, ...], Any] = {}
        if device_mesh is not None:
            self._make_groups()

    def __repr__(self):
        return f"Mesh({self.shape})"

    # ---------------------------------------------------- rank-side facts
    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 without a device mesh)."""
        if self.device_mesh is None or self.shape[axis] == 1:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def index(self, axes: Sequence[str]) -> int:
        """This rank's block index along a spec entry naming ``axes``:
        row-major over the axes in the order given, as JAX numbers the
        shards of a tuple entry."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coord(a)
        return i

    def group(self, axes: Sequence[str]):
        """The process group spanning ``axes`` that holds this rank (None
        when they have one rank: every collective over it is skipped)."""
        axes = tuple(a for a in self.axis_names if a in axes)
        if math.prod(self.shape[a] for a in axes) == 1:
            return None
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self._groups[axes]

    def _make_groups(self) -> None:
        """One group per set of two or more axes, made by every rank in the
        same order (``new_group`` is collective)."""
        import torch.distributed as dist
        ranks = self.device_mesh.mesh
        me = dist.get_rank()
        names = self.axis_names
        for r in range(2, len(names) + 1):
            for axes in itertools.combinations(names, r):
                dims = [names.index(a) for a in axes]
                rest = [d for d in range(len(names)) if d not in dims]
                moved = ranks.permute(*rest, *dims).reshape(
                    -1, math.prod(self.shape[a] for a in axes))
                for row in moved.tolist():
                    g = (dist.group.WORLD
                         if len(row) == dist.get_world_size()
                         else dist.new_group(row))
                    if me in row:
                        self._groups[axes] = g


def AbstractMesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh of named axis sizes with no ranks behind it (the counterpart
    of ``jax.sharding.AbstractMesh``): spec and shape arithmetic only."""
    return Mesh(shape, axis_names)


def as_mesh(mesh) -> Optional[Mesh]:
    """A :class:`Mesh` for ``mesh`` (a ``Mesh``, a ``DeviceMesh``, or
    None); a ``DeviceMesh``'s is made once (its groups are collective to
    make) and kept on it."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    if getattr(mesh, "_repro_torch_mesh", None) is None:
        mesh._repro_torch_mesh = Mesh(tuple(mesh.mesh.shape),
                                      mesh.mesh_dim_names, device_mesh=mesh)
    return mesh._repro_torch_mesh


class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart)."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def _axes(self, entry) -> Tuple[str, ...]:
        if entry is None:
            return ()
        return (entry,) if isinstance(entry, str) else tuple(entry)

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """Each rank's block shape; raises ``ValueError`` where JAX's
        ``shard_shape`` raises: a spec longer than the shape, or a dimension
        its axes do not divide (no padding, no dropped axis)."""
        shape = tuple(int(s) for s in global_shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec!r} is longer than the shape "
                             f"{shape}")
        out = list(shape)
        for d, entry in enumerate(self.spec):
            n = math.prod(self.mesh.shape[a] for a in self._axes(entry))
            if shape[d] % n:
                raise ValueError(
                    f"sharding {self!r} implies that array axis {d} is "
                    f"partitioned {n} times, but the dimension size is "
                    f"{shape[d]} (full shape: {shape})")
            out[d] = shape[d] // n
        return tuple(out)

    def local_slices(self, global_shape: Sequence[int],
                     coords: Optional[Dict[str, int]] = None
                     ) -> Tuple[slice, ...]:
        """The block of an array of ``global_shape`` held by the rank at
        ``coords`` (axis -> coordinate; this rank's by default)."""
        block = self.shard_shape(global_shape)
        at = coords or {a: self.mesh.coord(a) for a in self.mesh.axis_names}
        out = []
        for d, n in enumerate(block):
            i = 0
            for a in self._axes(self.spec[d] if d < len(self.spec) else None):
                i = i * self.mesh.shape[a] + at[a]
            out.append(slice(i * n, (i + 1) * n))
        return tuple(out)

    @property
    def placements(self) -> tuple:
        """``torch.distributed.tensor`` placements, one per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for a in self.mesh.axis_names:
            dims = [d for d, e in enumerate(self.spec) if a in self._axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


# ------------------------------------------------------------ ambient mesh
_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` (a :class:`Mesh` or a ``DeviceMesh``; None clears
    it) as the ambient mesh for the block: the counterpart of ``with
    mesh:``."""
    token = _AMBIENT.set(as_mesh(mesh))
    try:
        yield _AMBIENT.get()
    finally:
        _AMBIENT.reset(token)


def ambient_mesh() -> Optional[Mesh]:
    """The mesh installed by ``use_mesh``, or None outside any context."""
    return _AMBIENT.get()


def batch_axes(mesh: Mesh):
    """Mesh axes carrying batch/data parallelism, innermost last.

    Returns a bare axis name when only one qualifies (reads better in specs)
    and a tuple when the multi-pod mesh contributes ``pod`` as well.
    """
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if len(axes) == 1:
        return axes[0]
    return axes


def _axis_size(mesh: Mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return mesh.shape.get(entry, 1)
    size = 1
    for a in entry:
        size *= mesh.shape.get(a, 1)
    return size


def _resolve_entry(mesh: Mesh, entry, dim: int):
    """Map one spec entry onto the mesh; drop it if absent or non-dividing."""
    if entry == "batch":
        entry = batch_axes(mesh)
    if isinstance(entry, str):
        entry = (entry,)
    if entry is None:
        return None
    kept = tuple(a for a in entry if mesh.shape.get(a, 1) > 1)
    if not kept:
        return None
    size = _axis_size(mesh, kept)
    if dim % size != 0:
        return None
    return kept if len(kept) > 1 else kept[0]


def activation_spec(mesh: Mesh, axes: Sequence[Any], shape) -> P:
    """Resolve an abstract activation layout (``"batch"``/axis-name/None per
    dim) into a concrete PartitionSpec valid on ``mesh`` for ``shape``."""
    return P(*(_resolve_entry(mesh, a, d) for a, d in zip(axes, shape)))


def _model_dims(mesh: Mesh, spec: Sequence[Any]) -> Dict[int, Tuple[str,
                                                                     ...]]:
    """dim -> the axes a resolved spec cuts it over, the batch axes left
    out (the manual path holds every activation batch-local already)."""
    ba = batch_axes(mesh)
    ba = (ba,) if isinstance(ba, str) else tuple(ba)
    out = {}
    for d, e in enumerate(spec):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        if all(a in ba for a in axes):
            continue
        out[d] = axes
    return out


def _global_shape(mesh: Mesh, x: torch.Tensor, axes: Sequence[Any]):
    """``x``'s shape with its batch dim (the ``"batch"`` entry) scaled back
    to the global batch, for the divisibility rules of ``_resolve_entry``."""
    shape = list(x.shape)
    for d, a in enumerate(axes):
        if a == "batch":
            shape[d] *= _axis_size(mesh, batch_axes(mesh))
    return shape


def shard_activation(x: torch.Tensor, axes: Sequence[Any]) -> torch.Tensor:
    """Constrain ``x`` to the given layout under the ambient mesh (identity
    when no mesh is installed — the single-device test path).

    On the mesh path ``x`` is the rank's tensor, batch-local and whole on
    every other dim; the result is its block along each other dim the
    layout resolves onto the mesh (autograd: the backward all-gathers)."""
    mesh = ambient_mesh()
    if mesh is None:
        return x
    spec = activation_spec(mesh, axes, _global_shape(mesh, x, axes))
    return _cut(mesh, x, spec)


def unshard_activation(x: torch.Tensor, axes: Sequence[Any],
                       shape: Sequence[int]) -> torch.Tensor:
    """The inverse of :func:`shard_activation` (no reference counterpart:
    GSPMD inserts this all-gather itself): ``x`` is the rank's block of a
    tensor of ``shape`` (its batch dim the rank's rows) under the layout
    ``axes``; the result is whole on every dim but the batch dim (autograd:
    the backward keeps the rank's block of a gradient every rank holds
    whole)."""
    mesh = ambient_mesh()
    if mesh is None:
        return x
    from . import spmd
    whole = list(shape)
    for d, a in enumerate(axes):
        if a == "batch":
            whole[d] *= _axis_size(mesh, batch_axes(mesh))
    spec = activation_spec(mesh, axes, whole)
    for d, ax in _model_dims(mesh, spec).items():
        x = spmd.gather(x, mesh, ax, d)
    return x


def _cut(mesh: Mesh, x: torch.Tensor, spec: Sequence[Any]) -> torch.Tensor:
    from . import spmd
    for d, ax in _model_dims(mesh, spec).items():
        x = spmd.split(x, mesh, ax, d)
    return x


def maybe_shard(x: torch.Tensor, spec: P) -> torch.Tensor:
    """The rank's block of ``x`` under ``spec`` iff an ambient mesh exists
    and ``spec`` is realizable on it (absent axes / non-dividing dims are
    dropped; entries naming only batch axes name what is already local)."""
    mesh = ambient_mesh()
    if mesh is None:
        return x
    entries = tuple(spec) + (None,) * (x.dim() - len(tuple(spec)))
    resolved = activation_spec(mesh, entries, x.shape)
    return _cut(mesh, x, resolved)


def to_shardings(mesh: Mesh, spec_tree):
    """PartitionSpec tree -> NamedSharding tree on ``mesh``."""
    mesh = as_mesh(mesh)

    def walk(s):
        if isinstance(s, P):
            return NamedSharding(mesh, s)
        if isinstance(s, dict):
            return {k: walk(v) for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            return type(s)(walk(v) for v in s)
        return s
    return walk(spec_tree)


# ------------------------------------------------------ LM parameter specs
def _mdl(mesh: Mesh, dim: int):
    """The model axis, if present and dividing ``dim``; else replicate."""
    if "model" in mesh.axis_names and mesh.shape["model"] > 1 \
            and dim % mesh.shape["model"] == 0:
        return "model"
    return None


def lm_param_specs(cfg, mesh: Mesh):
    """PartitionSpec tree for the stacked LM parameter pytree (lm_init).

    Layout: tensor parallelism on ``model`` (column-parallel wq/wk/wv/wg/wu,
    row-parallel wo/wd, expert-parallel MoE stacks when E divides the model
    axis), ZeRO over the batch axes on the leading LAYER-STACK axis.  The
    structure intentionally uses single-P leaves for uniform sub-pytrees
    (linear {"w"}, rmsnorm {"scale"}) — consumers broadcast them.
    """
    mesh = as_mesh(mesh)
    ba = batch_axes(mesh)
    zb = ba  # ZeRO shard of the layer stack axis
    d, hd = cfg.d_model, cfg.hd
    qout, kvout = cfg.n_heads * hd, cfg.n_kv * hd

    def attn_specs():
        return {"wq": P(zb, None, _mdl(mesh, qout)),
                "wk": P(zb, None, _mdl(mesh, kvout)),
                "wv": P(zb, None, _mdl(mesh, kvout)),
                "wo": P(zb, _mdl(mesh, qout), None)}

    def layer_common():
        return {"attn": attn_specs(), "ln1": P(zb, None), "ln2": P(zb, None)}

    specs = {
        "embed": P(_mdl(mesh, cfg.vocab), None),
        "ln_f": P(None),
        "head": P(None, _mdl(mesh, cfg.vocab)),
    }
    f = cfg.d_ff
    if cfg.n_experts:
        mdl_sz = mesh.shape.get("model", 1)
        moe = layer_common()
        if mdl_sz > 1 and cfg.n_experts % mdl_sz == 0:
            # expert parallelism: whole experts per model shard
            ew = P(zb, "model", None, None)
            moe["moe"] = {"router": P(zb, None, None),
                          "wg": ew, "wu": ew, "wd": ew}
        else:
            # tensor parallelism inside each expert
            moe["moe"] = {"router": P(zb, None, None),
                          "wg": P(zb, None, None, _mdl(mesh, f)),
                          "wu": P(zb, None, None, _mdl(mesh, f)),
                          "wd": P(zb, None, _mdl(mesh, f), None)}
        if cfg.shared_expert:
            moe["moe"]["shared"] = {"wg": P(zb, None, _mdl(mesh, f)),
                                    "wu": P(zb, None, _mdl(mesh, f)),
                                    "wd": P(zb, _mdl(mesh, f), None)}
        specs["moe_layers"] = moe
        if cfg.n_dense_layers:
            dense = layer_common()
            dense["ffn"] = {"wg": P(zb, None, _mdl(mesh, f)),
                            "wu": P(zb, None, _mdl(mesh, f)),
                            "wd": P(zb, _mdl(mesh, f), None)}
            specs["dense_layers"] = dense
    else:
        dense = layer_common()
        dense["ffn"] = {"wg": P(zb, None, _mdl(mesh, f)),
                        "wu": P(zb, None, _mdl(mesh, f)),
                        "wd": P(zb, _mdl(mesh, f), None)}
        specs["dense_layers"] = dense
    return specs


def _tensor_leaf(t) -> bool:
    return not isinstance(t, (dict, list, tuple))


def leaves(tree, is_leaf=_tensor_leaf) -> list:
    """The leaves of a nested dict / list / tuple tree, in order (a P is
    a leaf)."""
    if isinstance(tree, P) or is_leaf(tree):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [x for v in vals for x in leaves(v, is_leaf)]


def map_specs(fn, tree):
    """``fn`` over the P leaves of a spec tree."""
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v) for v in tree)
    return tree


def broadcast_specs(spec_tree, tree, is_leaf=_tensor_leaf):
    """The spec tree broadcast over ``tree`` (in ``tree``'s order): a
    single-P leaf of the spec tree stands for every leaf of the sub-tree
    under it."""
    def over(t, spec):
        if is_leaf(t):
            return spec
        if isinstance(t, dict):
            return {k: over(v, spec) for k, v in t.items()}
        return type(t)(over(v, spec) for v in t)

    def walk(spec, t):
        if isinstance(spec, P):
            return over(t, spec)
        if isinstance(spec, dict):
            return {k: walk(spec[k], t[k]) for k in t}
        if isinstance(spec, (list, tuple)):
            return type(spec)(walk(s, v) for s, v in zip(spec, t))
        raise TypeError(type(spec))
    return walk(spec_tree, tree)
