"""Logical-axis sharding rules (MaxText/T5X style), in the port.

Counterpart of ``repro.parallel.sharding``.  Models annotate every
parameter with *logical* axis names ("batch", "heads", "ff", "experts",
"fsdp", …).  A rule table maps logical names to physical mesh axes per
deployment, so the same model code describes a single pod (data, model),
a multi-pod (pod, data, model) or no mesh at all.

Divisibility guard: a logical axis is left unsharded for a tensor whose
dimension does not divide by the mapped mesh-axis size (a 39-field
embedding table over 16 devices stays replicated on that dim).

The port is one controller that holds every tensor whole on its device
(``parallel/placement.py``), so a spec here is metadata: the launch step
builder divides argument bytes by it, and the MoE reads the batch axis's
shard count from the active :class:`ShardingContext`.  A layout
constraint changes no value, so :func:`shard_constraint` and
:func:`shard` return ``x`` unchanged, and the port's models do not call
them (``repro``'s activation constraints are layout hints to XLA).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Union

MeshAxes = Union[None, str, tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None``, a mesh axis name, or a
    tuple of axis names.  Equality is the tuple's, as ``repro``'s
    ``PartitionSpec`` keeps it: ``P("a") != P(("a",))``."""

    def __new__(cls, *parts: MeshAxes) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(tuple(self))


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Mapping logical axis name → physical mesh axis (or axes)."""

    rules: tuple[tuple[str, MeshAxes], ...]

    def get(self, name: Optional[str]) -> MeshAxes:
        if name is None:
            return None
        for k, v in self.rules:
            if k == name:
                return v
        return None

    def replace(self, **updates: MeshAxes) -> "AxisRules":
        new = dict(self.rules)
        new.update(updates)
        return AxisRules(tuple(new.items()))


# Single-pod production mesh: (data=16, model=16).
SINGLE_POD_RULES = AxisRules((
    ("batch", "data"),
    ("fsdp", "data"),
    ("tensor", "model"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("ff", "model"),
    ("experts", "model"),
    ("vocab", "model"),
    ("kb_docs", "model"),          # retrieval index rows
    ("kv_seq", None),              # decode KV cache sequence axis
    ("seq", None),
    ("embed", None),
    ("d_model", None),
))

# Multi-pod mesh: (pod=2, data=16, model=16).  Batch/FSDP span the pod axis
# (cross-pod traffic = gradient all-reduce + FSDP gathers only).
MULTI_POD_RULES = AxisRules((
    ("batch", ("pod", "data")),
    ("fsdp", ("pod", "data")),
    ("tensor", "model"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("ff", "model"),
    ("experts", "model"),
    ("vocab", "model"),
    ("kb_docs", ("pod", "model")),  # pods add KB capacity
    ("kv_seq", None),
    ("seq", None),
    ("embed", None),
    ("d_model", None),
))


def _axis_size(mesh, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def spec_for_shape(shape: Sequence[int], logical: Sequence[Optional[str]],
                   rules: AxisRules, mesh) -> PartitionSpec:
    """PartitionSpec for a tensor, dropping non-divisible shardings.

    Reads only ``mesh.shape`` (axis → size), so any object with that dict
    serves as the mesh."""
    if mesh is None:
        return P()
    parts: list[MeshAxes] = []
    used: set[str] = set()
    for dim, name in zip(shape, logical):
        ax = rules.get(name)
        if ax is None:
            parts.append(None)
            continue
        ax_t = (ax,) if isinstance(ax, str) else tuple(ax)
        # skip axes already used by an earlier dim (illegal to reuse)
        ax_t = tuple(a for a in ax_t if a not in used)
        if not ax_t:
            parts.append(None)
            continue
        size = 1
        for a in ax_t:
            size *= mesh.shape[a]
        if size <= 1 or dim % size != 0:
            # try a prefix of the axes that divides
            while ax_t and (dim % _axis_size(mesh, ax_t) != 0):
                ax_t = ax_t[:-1]
            if not ax_t:
                parts.append(None)
                continue
        used.update(ax_t)
        # preserve the rule's form: a tuple-valued rule stays a tuple even
        # when the divisibility guard shrinks it to one axis
        parts.append(ax_t if isinstance(ax, tuple) else ax_t[0])
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def spec_shards(spec: Sequence[MeshAxes], mesh) -> int:
    """How many pieces ``spec`` cuts a tensor into on ``mesh``."""
    n = 1
    for part in spec:
        n *= _axis_size(mesh, part)
    return n


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def logical_to_spec(tree_logical: Any, tree_shapes: Any, rules: AxisRules,
                    mesh) -> Any:
    """Map a tree of logical-axis tuples (and the matching shapes, or
    tensors) to specs, over the port's trees of dicts, lists and tuples."""
    if _is_logical(tree_logical):
        shape = getattr(tree_shapes, "shape", tree_shapes)
        return spec_for_shape(tuple(shape), tree_logical, rules, mesh)
    if isinstance(tree_logical, dict):
        return {k: logical_to_spec(v, tree_shapes[k], rules, mesh)
                for k, v in tree_logical.items()}
    return type(tree_logical)(
        logical_to_spec(v, tree_shapes[i], rules, mesh)
        for i, v in enumerate(tree_logical))


def shard_constraint(x, logical: Sequence[Optional[str]],
                     rules: Optional[AxisRules], mesh):
    """``repro``'s ``with_sharding_constraint`` by logical names: a layout
    constraint changes no value, and the single controller holds ``x``
    whole, so ``x`` is returned unchanged."""
    return x


class ShardingContext:
    """Carries (mesh, rules) through model code without threading args.

    With no active context the models run unsharded; under one, the MoE
    dispatches in as many groups as the "batch" axes have shards.
    """

    _active: Optional["ShardingContext"] = None

    def __init__(self, mesh, rules: Optional[AxisRules]):
        self.mesh = mesh
        self.rules = rules

    def __enter__(self) -> "ShardingContext":
        self._prev = ShardingContext._active
        ShardingContext._active = self
        return self

    def __exit__(self, *exc) -> None:
        ShardingContext._active = self._prev

    @classmethod
    def current(cls) -> Optional["ShardingContext"]:
        return cls._active


def shard(x, *logical: Optional[str]):
    """``ctx.shard(x, "batch", "seq", None)`` in ``repro``: the identity
    here (see :func:`shard_constraint`)."""
    return x
