"""Bytes moved by the port's own collectives.

The single controller performs a collective as copies onto one device
(the gathered codes of a compressed gradient exchange, the candidates of
the KB search's cross-shard merge).  Each such step adds the bytes of
the array it gathers, by op name, to a :class:`CollectiveCounter`: the
output shape of the collective, as ``repro``'s roofline reads it from
XLA's HLO.  :func:`repro_torch.launch.roofline.analyze` reads
:data:`COUNTER` around the step it measures.
"""

from __future__ import annotations

import torch


class CollectiveCounter:
    """{op name: bytes} since the last :meth:`reset`."""

    def __init__(self) -> None:
        self.bytes: dict[str, int] = {}

    def add(self, op: str, *tensors: torch.Tensor) -> None:
        n = sum(t.numel() * t.element_size() for t in tensors)
        self.bytes[op] = self.bytes.get(op, 0) + n

    def reset(self) -> None:
        self.bytes = {}

    def total(self) -> int:
        return sum(self.bytes.values())


#: the counter every port collective adds to
COUNTER = CollectiveCounter()
