"""Production mesh builders.

Counterpart of ``repro.launch.mesh``.  The meshes keep ``repro``'s
shapes and axis names, and every position sits on one named device
(``cuda:0`` on the card, ``cpu`` in tests, ``meta`` for abstract passes),
as the sharded search's meshes do (``parallel/placement.py``): the single
controller holds each tensor whole, and a mesh only sizes the specs.
``device=None`` means ``cuda:0`` and raises without CUDA.
"""

from __future__ import annotations

from repro_torch.parallel.placement import Mesh
from repro_torch.parallel.sharding import (AxisRules, MULTI_POD_RULES,
                                           SINGLE_POD_RULES)
from repro_torch.train.elastic import build_mesh
from repro_torch.utils import DeviceLike, resolve_device


def _named(device: DeviceLike):
    return resolve_device("cuda:0" if device is None else device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    """The pod mesh: (data=16, model=16); two pods add a leading "pod"
    axis: (pod=2, data=16, model=16)."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    return build_mesh(shape, _named(device))


def rules_for_mesh(mesh) -> AxisRules:
    return MULTI_POD_RULES if "pod" in mesh.axis_names else SINGLE_POD_RULES


def make_test_mesh(n_devices: int = 8, model: int = 2,
                   device: DeviceLike = None) -> Mesh:
    """A small (data, model) mesh for tests."""
    return build_mesh({"data": n_devices // model, "model": model},
                      _named(device))
