"""Published dense peaks by card name: a frozen copy of the program's
``repro_torch/launch/roofline.py::CARDS`` (NVIDIA's data sheets; the SXM
part is the default), so a change to the program cannot move the
yardstick."""

from __future__ import annotations

#: name fragment → (bytes/s, bf16 FLOP/s, int8 OP/s, f32 FLOP/s)
CARDS = {
    "H100 PCIe": (2.0e12, 756e12, 1513e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 1671e12, 60e12),
    "H200": (4.8e12, 989e12, 1979e12, 67e12),
    "H100": (3.35e12, 989e12, 1979e12, 67e12),
}


def rates(card: str) -> dict:
    """{"bytes", "bf16", "int8", "f32"} per second for ``card``."""
    for frag, r in CARDS.items():
        if frag in card:
            break
    else:
        r = CARDS["H100"]
    return dict(zip(("bytes", "bf16", "int8", "f32"), r))


def bound_s(n_bytes: float, n_ops: float, op_rate: float,
            byte_rate: float) -> tuple[float, str]:
    """The least time a call could take, and which of the two bounds it."""
    t_bytes, t_ops = n_bytes / byte_rate, n_ops / op_rate
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
