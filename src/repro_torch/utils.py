"""Shared helpers: chunking, divisors, byte counts, and the device and
backend contracts.

Device: every entry point takes ``device=None``, which means ``"cuda"``.
Asking for CUDA where there is none raises — the package never carries on
quietly on the CPU; the CPU is used only when the caller names it.

Backend (which numerics score quantized storage):

* ``"torch"``  — ``repro``'s ``jnp`` numerics: decode to f32, then GEMM.
* ``"kernel"`` — ``repro``'s ``pallas`` numerics, computed by the Hopper
  kernels on a CUDA tensor and by each kernel's plain version on a CPU
  tensor.
* ``"auto"``   — ``kernel`` on a CUDA device, ``torch`` on the CPU.

Artifacts and spec JSON keep ``repro``'s names (``auto``/``jnp``/``pallas``):
:func:`check_backend` maps them in, :func:`backend_to_repro` out.
"""

from __future__ import annotations

from typing import Iterable, Optional, Union

import torch

BACKENDS = ("auto", "torch", "kernel")

_FROM_REPRO = {"auto": "auto", "jnp": "torch", "pallas": "kernel"}
_TO_REPRO = {"auto": "auto", "torch": "jnp", "kernel": "pallas"}

DeviceLike = Union[str, torch.device, None]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def first_divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= cap (>=1)."""
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB", "PiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} EiB"


def chunked(n: int, chunk: int) -> Iterable[tuple[int, int]]:
    """Yield (start, stop) covering [0, n) in chunks."""
    for start in range(0, n, chunk):
        yield start, min(start + chunk, n)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available — pass device='cpu' "
            "to run on the CPU")
    return dev


def check_backend(backend: str) -> str:
    """Validate a port backend name; ``repro``'s names map to the port's."""
    if backend in _FROM_REPRO:
        return _FROM_REPRO[backend]
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    return backend


def backend_to_repro(backend: str) -> str:
    """The port's backend name → ``repro``'s (what artifacts store)."""
    return _TO_REPRO[check_backend(backend)]


def use_kernel(backend: str, device: Optional[torch.device]) -> bool:
    """Does ``backend`` on ``device`` score with kernel numerics?"""
    backend = check_backend(backend)
    if backend == "auto":
        return device is not None and torch.device(device).type == "cuda"
    return backend == "kernel"
