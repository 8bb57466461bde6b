"""Roofline terms of a step on the NVIDIA H100 (counterpart of
``repro.launch.roofline``, which models a TPU v5e from XLA's artifacts).

Per (arch × shape × mesh) cell:

    compute term    = FLOPs            / (chips × peak bf16 FLOP/s)
    memory term     = bytes            / (chips × HBM bytes/s)
    collective term = collective bytes / (chips × NVLink bytes/s)

The port has no compiler artifacts, so :func:`analyze` runs the step once
under a ``TorchDispatchMode``, normally over meta tensors (no storage, no
compute), and counts what each aten op does:

- FLOPs from ``torch.utils.flop_counter``'s registry, as
  ``FlopCounterMode`` counts them (matrix products, convolutions,
  attention);
- bytes as every op's input and output bytes (view ops, which move
  nothing, excluded).  That is the counterpart of XLA's "bytes accessed"
  before fusion: an upper bound, since a fused kernel keeps its
  temporaries on chip;
- collective bytes as the port's own collectives count them
  (:data:`repro_torch.parallel.collectives.COUNTER`: the compressed
  gradient exchange and the KB search's cross-shard merge).

A step whose collectives XLA would insert — the LM, GNN and recsys
steps, whose single-controller form performs none — has no collective
term: it is ``None``, printed "not modelled", never 0, and the bottleneck
is taken over the terms that are modelled.

``repro``'s ``collective_bytes(hlo_text)`` parses XLA's optimised HLO;
the port has no HLO, so it has no counterpart here.

The rates: :data:`CARDS` holds NVIDIA's data-sheet dense rates by card
name (one copy, which ``chip_smoke.py`` imports too).  The link rate is
NVLink's per-direction rate on the SXM part, 18 links × 25 GB/s; traffic
between nodes runs at the network's rate, which this model does not know.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.parallel.collectives import COUNTER

#: name fragment → (bytes/s, bf16 FLOP/s, int8 OP/s, f32 FLOP/s), dense
#: rates from NVIDIA's data sheets; the SXM part is the default
CARDS = {
    "H100 PCIe": (2.0e12, 756e12, 1513e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 1671e12, 60e12),
    "H200": (4.8e12, 989e12, 1979e12, 67e12),
    "H100": (3.35e12, 989e12, 1979e12, 67e12),
}

#: NVLink 4 on the H100 SXM: 18 links × 25 GB/s a direction
NVLINK_BW = 450e9


def card_rates(name: str) -> tuple[float, float, float, float]:
    for frag, rates in CARDS.items():
        if frag in name:
            return rates
    return CARDS["H100"]


@dataclasses.dataclass
class RooflineReport:
    name: str
    mesh: str
    chips: int
    hlo_gflops: float            # total across chips
    hlo_gbytes: float
    coll_gbytes: Optional[float]     # None: collectives not modelled
    per_collective: dict
    model_gflops: Optional[float]
    peak_memory_bytes: Optional[int]
    card: str = "H100"

    @property
    def _rates(self) -> tuple[float, float, float, float]:
        return card_rates(self.card)

    @property
    def t_compute(self) -> float:
        return self.hlo_gflops * 1e9 / (self.chips * self._rates[1])

    @property
    def t_memory(self) -> float:
        return self.hlo_gbytes * 1e9 / (self.chips * self._rates[0])

    @property
    def t_collective(self) -> Optional[float]:
        if self.coll_gbytes is None:
            return None
        return self.coll_gbytes * 1e9 / (self.chips * NVLINK_BW)

    @property
    def _terms(self) -> dict[str, float]:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        terms = self._terms
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline-model step time: max of the modelled terms (perfect
        overlap assumption — the optimistic bound)."""
        return max(self._terms.values())

    @property
    def roofline_fraction(self) -> float:
        """useful-FLOPs throughput vs peak, at roofline step time."""
        if not self.model_gflops or self.step_time <= 0:
            return 0.0
        achieved = self.model_gflops * 1e9 / self.step_time
        return achieved / (self.chips * self._rates[1])

    @property
    def flops_efficiency(self) -> float:
        """MODEL_FLOPS / counted FLOPs — how much counted compute is
        useful."""
        if not self.model_gflops or not self.hlo_gflops:
            return 0.0
        return self.model_gflops / self.hlo_gflops

    def to_dict(self) -> dict:
        return {
            "name": self.name, "mesh": self.mesh, "chips": self.chips,
            "card": self.card,
            "hlo_gflops": self.hlo_gflops, "hlo_gbytes": self.hlo_gbytes,
            "coll_gbytes": self.coll_gbytes,
            "per_collective": self.per_collective,
            "model_gflops": self.model_gflops,
            "peak_memory_bytes": self.peak_memory_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time,
            "roofline_fraction": self.roofline_fraction,
            "flops_efficiency": self.flops_efficiency,
        }


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(x.numel() * x.element_size() for x in leaves
               if isinstance(x, torch.Tensor))


class OpCounter(TorchDispatchMode):
    """FLOPs (``flop_counter``'s registry) and bytes (inputs + outputs of
    every op that is not a view) of the aten ops run under it."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not func.is_view:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def count_step(fn: Callable, args: tuple) -> tuple[int, int, dict, object]:
    """Run ``fn(*args)`` once under :class:`OpCounter` → (FLOPs, bytes,
    {collective op: bytes}, output)."""
    COUNTER.reset()
    with OpCounter() as c:
        out = fn(*args)
    coll = dict(COUNTER.bytes)
    COUNTER.reset()
    return c.flops, c.bytes, coll, out


def analyze(name: str, mesh_desc: str, chips: int, fn: Callable,
            args: tuple, model_flops: Optional[float] = None,
            collectives: bool = True, card: str = "H100"
            ) -> RooflineReport:
    """Build a report from one counted run of ``fn(*args)``.

    ``collectives=False`` marks a step whose collectives are not modelled
    (its collective term is ``None``)."""
    flops, nbytes, coll, _ = count_step(fn, args)
    return RooflineReport(
        name=name, mesh=mesh_desc, chips=chips,
        hlo_gflops=flops / 1e9, hlo_gbytes=nbytes / 1e9,
        coll_gbytes=(sum(coll.values()) / 1e9 if collectives else None),
        per_collective=coll,
        model_gflops=(model_flops / 1e9 if model_flops else None),
        peak_memory_bytes=None, card=card)
