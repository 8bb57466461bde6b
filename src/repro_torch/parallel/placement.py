"""Placement: one surface that turns a ``ShardSpec`` into a device mesh.

Counterpart of ``repro.parallel.placement``.  ``repro`` is one controller
driving a ``jax.sharding.Mesh`` through ``shard_map``; here one process
drives every shard too, and the mesh is a grid of ``torch.device``\\ s:

* :class:`Mesh` — a numpy array of ``torch.device`` with ``axis_names``;
  ``mesh.shape[axis]`` is that axis's size, as ``repro``'s code reads it.
* :func:`mesh_from_spec` builds the mesh a
  :class:`~repro_torch.retrieval.api.ShardSpec` describes, with
  ``repro``'s layout: the query (replica) axis first when there is one,
  then the doc axes, the shard count on the last of them.  Storage is
  replicated over the query axis and queries are split over it.
* :func:`place_shards` is the one choke point the sharded indexes place
  their per-shard storage through.  ``SHARD_PLACEMENT_HOOK`` runs once
  per shard before any copy, so a failing shard aborts the placement with
  nothing copied — the serving layer's all-or-none staging hangs off it.

The device rule (``devices=`` of :func:`mesh_from_spec` and ``device=`` of
the entry points that build a mesh):

* ``None`` spreads the mesh over the distinct CUDA devices, one mesh
  position each.  It raises without CUDA, and raises as ``repro`` does
  where the replicas do not divide the devices or the spec wants more
  devices than there are.
* A named device (``"cpu"``, ``"cuda:0"``, a ``torch.device``) holds every
  position of the mesh on that one device — the counterpart of ``repro``'s
  forced host devices: a spec with ``shards=None`` gets one shard there.
* A list (or tuple) of devices is taken as given, with ``None``'s rules.

Nothing falls back to the CPU: a CUDA device that is asked for and absent
raises.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.utils import resolve_device

#: test/ops seam: ``hook(shard_id, n_shards)`` runs before each shard is
#: placed; an exception aborts the whole placement (see module docstring)
SHARD_PLACEMENT_HOOK: Optional[Callable[[int, int], None]] = None


class Mesh:
    """A grid of ``torch.device``\\ s with named axes."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d device grid for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def _is_named(devices) -> bool:
    return isinstance(devices, (str, torch.device))


def available_devices(devices=None) -> list[torch.device]:
    """The devices a mesh may use under the device rule (module docstring):
    every CUDA device for ``None``, the one device named, or the list."""
    if devices is None:
        resolve_device(None)           # raises without CUDA
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if _is_named(devices):
        return [resolve_device(devices)]
    return [resolve_device(d) for d in devices]


def mesh_from_spec(spec, devices=None) -> Mesh:
    """The mesh a :class:`~repro_torch.retrieval.api.ShardSpec` describes.

    Shape ``(replicas, shards)`` over ``(query axis, doc axes)``; with
    ``spec.shards=None`` every device the replica count leaves available
    goes to the doc axis (one shard on a named device).  A multi-axis
    ``doc_axis`` puts the shard count on its last axis and sizes the
    leading ones 1, as ``repro`` does.
    """
    devs = available_devices(devices)
    replicas = int(getattr(spec, "replicas", 1) or 1)
    if replicas < 1:
        raise ValueError(f"replicas must be ≥ 1, got {replicas}")
    shards = spec.shards
    if _is_named(devices):
        shards = 1 if shards is None else int(shards)
        need = replicas * shards
        grid = [devs[0]] * need
    else:
        if len(devs) % replicas:
            raise ValueError(
                f"replicas={replicas} does not divide the {len(devs)} "
                "available devices")
        if shards is None:
            shards = max(1, len(devs) // replicas)
        shards = int(shards)
        need = replicas * shards
        if need > len(devs):
            raise ValueError(
                f"ShardSpec wants {shards} shards × {replicas} replicas = "
                f"{need} devices but only {len(devs)} are available — name "
                "one device (device='cuda:0' or 'cpu') to hold every shard "
                "there, or shrink the spec")
        grid = devs[:need]
    doc_axes = (spec.doc_axis,) if isinstance(spec.doc_axis, str) \
        else tuple(spec.doc_axis)
    q_axis = spec.effective_query_axis
    axes: list[str] = []
    shape: list[int] = []
    if q_axis is not None:
        axes.append(q_axis)
        shape.append(replicas)
    for a in doc_axes[:-1]:
        axes.append(a)
        shape.append(1)
    axes.append(doc_axes[-1])
    shape.append(shards)
    dev_grid = np.empty(need, dtype=object)
    dev_grid[:] = grid
    return Mesh(dev_grid.reshape(tuple(shape)), axes)


def device_grid(mesh: Mesh, doc_axes: Sequence[str],
                query_axes: Sequence[str]) -> np.ndarray:
    """The (query shards, doc shards) grid of devices: query shard ``r``
    scores doc shard ``s`` on ``grid[r, s]``.  Doc shard ids are
    row-major over ``doc_axes``, as ``repro``'s ``axis_index`` product;
    axes the index does not name are replicated (position 0 serves)."""
    names = list(mesh.axis_names)
    for a in (*doc_axes, *query_axes):
        if a not in names:
            raise ValueError(f"mesh has no axis {a!r} (axes {tuple(names)})")
    rest = [a for a in names if a not in doc_axes and a not in query_axes]
    order = [names.index(a) for a in (*query_axes, *doc_axes, *rest)]
    grid = np.transpose(mesh.devices, order)
    grid = grid[(Ellipsis,) + (0,) * len(rest)] if rest else grid
    n_q = int(np.prod([mesh.shape[a] for a in query_axes], dtype=np.int64))
    n_d = int(np.prod([mesh.shape[a] for a in doc_axes], dtype=np.int64))
    return grid.reshape(n_q, n_d)


def place_shards(shards: Sequence[Sequence[torch.Tensor]],
                 grid: np.ndarray) -> list[list[list[torch.Tensor]]]:
    """Copy each doc shard's tensors to its devices, one hook call per
    shard first.

    ``shards[s]`` holds doc shard ``s``'s tensors; ``grid`` is the
    (query shards, doc shards) device grid of :func:`device_grid`.
    Returns ``placed[r][s]``, shard ``s``'s tensors on ``grid[r, s]``
    (one copy per distinct device: replicas on one device share it, and a
    tensor already there is not copied).  The hook fires for every shard
    before any copy, so a raised exception means nothing was placed.
    """
    n_shards = len(shards)
    if grid.shape[1] != n_shards:
        raise ValueError(f"{n_shards} shards for a grid of "
                         f"{grid.shape[1]} doc shards")
    hook = SHARD_PLACEMENT_HOOK
    if hook is not None:
        for sid in range(n_shards):
            hook(sid, n_shards)
    copies: dict[tuple[int, torch.device], list[torch.Tensor]] = {}
    placed = []
    for r in range(grid.shape[0]):
        row = []
        for s, tensors in enumerate(shards):
            key = (s, grid[r, s])
            if key not in copies:
                copies[key] = [t.to(grid[r, s]) for t in tensors]
            row.append(copies[key])
        placed.append(row)
    return placed
