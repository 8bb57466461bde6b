"""Elastic re-meshing: resume a checkpoint onto a different device count.

Counterpart of ``repro.train.elastic``.  The recovery path after node
loss (or fleet growth):

    1. the controller picks the new healthy device set,
    2. builds a new mesh (the data axis shrinks or grows; the model axis is
       kept so tensor-parallel weights keep their layout),
    3. restores the latest checkpoint and places it on the new mesh
       (:func:`reshard_state`),
    4. training resumes at the saved step; the data pipeline is stateless
       in the step index, so no samples are lost or duplicated.

Batch handling on shrink: the global batch is kept by raising the
gradient-accumulation factor (microbatches ×= old_data/new_data), so the
optimizer sees the same statistics.

The port is one controller that holds each tensor whole
(``parallel/placement.py``): placing a state on a mesh moves every leaf
to the mesh's lead device (its first position), after checking that each
leaf's spec names only axes the mesh has.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.parallel.placement import Mesh, _is_named, available_devices
from repro_torch.parallel.sharding import PartitionSpec
from repro_torch.utils import first_divisor_leq


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    old_shape: dict[str, int]
    new_shape: dict[str, int]
    microbatch_scale: int        # multiply grad-accum by this on shrink

    @property
    def data_scale(self) -> float:
        return self.old_shape.get("data", 1) / self.new_shape.get("data", 1)


def plan_remesh(old_mesh_shape: dict[str, int], n_devices: int,
                model_axis: str = "model") -> RemeshPlan:
    """Choose a new mesh shape for ``n_devices``, preserving the model axis."""
    model = old_mesh_shape.get(model_axis, 1)
    if n_devices % model != 0:
        model = first_divisor_leq(n_devices, model)
    data = n_devices // model
    new_shape = {"data": data, model_axis: model}
    old_data = old_mesh_shape.get("data", 1) * old_mesh_shape.get("pod", 1)
    scale = max(1, int(np.ceil(old_data / data)))
    return RemeshPlan(old_shape=dict(old_mesh_shape), new_shape=new_shape,
                      microbatch_scale=scale)


def build_mesh(shape: dict[str, int], devices=None) -> Mesh:
    """A mesh of ``shape`` (axis → size) under the device rule of
    :func:`~repro_torch.parallel.placement.mesh_from_spec`: ``None`` means
    the CUDA devices (raises without CUDA), a named device holds every
    position, a list is taken as given."""
    n = int(np.prod(list(shape.values()), dtype=np.int64))
    devs = available_devices(devices)
    if _is_named(devices):
        devs = devs * n
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    return Mesh(grid.reshape(tuple(shape.values())), tuple(shape.keys()))


def lead_device(mesh: Mesh) -> torch.device:
    """The device at the mesh's first position."""
    return mesh.devices.flat[0]


def _check_spec(spec: Optional[Sequence], mesh: Mesh) -> None:
    for part in spec or ():
        for a in ((part,) if isinstance(part, str) else (part or ())):
            if a not in mesh.axis_names:
                raise ValueError(f"spec {spec!r} names axis {a!r}, which "
                                 f"the mesh {mesh.axis_names} lacks")


def reshard_state(state: Any, specs: Any, new_mesh: Mesh) -> Any:
    """Move a state tree onto ``new_mesh`` (leaf by leaf, ``specs`` of the
    same structure with a :class:`PartitionSpec` per tensor)."""
    dev = lead_device(new_mesh)

    def place(x, spec):
        if isinstance(x, torch.Tensor):
            _check_spec(spec, new_mesh)
            return x.to(dev)
        if isinstance(x, dict):
            return {k: place(v, spec[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)) and not isinstance(x,
                                                             PartitionSpec):
            out = [place(v, spec[i]) for i, v in enumerate(x)]
            return type(x)(*out) if hasattr(x, "_fields") else type(x)(out)
        return x

    return place(state, specs)
