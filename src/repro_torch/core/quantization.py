"""Precision reduction (paper §4.4) — fp16, int8, and 1-bit quantization.

Each quantizer is a :class:`Transform` whose ``__call__`` returns the
dequantized float values; ``encode``/``decode`` give the compact storage
(fp16 / uint8 codes / bit-packed words) that the scoring kernels in
:mod:`repro_torch.kernels` read directly.  Counterpart of
``repro.core.quantization``.

Packed words are held as **int32** with the bytes of ``repro``'s uint32
words: torch has no shifts on uint32.  Bit j of word w is the sign of
element 32·w + j (1 for x ≥ 0), bit 31 included — it is the int32 sign bit.
Convert with ``.view(np.int32)`` / ``.view(np.uint32)`` at the numpy
boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.preprocess import Transform

_INT32_MIN = torch.iinfo(torch.int32).min       # bit 31 alone
_FLOAT_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16}


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """Pack the sign bits of ``x`` (…, d) into int32 words (…, d/32).

    d must be a multiple of 32 (pad upstream if needed).
    """
    d = x.shape[-1]
    if d % 32 != 0:
        raise ValueError(f"pack_bits needs d % 32 == 0, got d={d}")
    bits = (x >= 0).to(torch.int32).reshape(*x.shape[:-1], d // 32, 32)
    shifts = torch.arange(31, dtype=torch.int32, device=x.device)
    low = torch.sum(bits[..., :31] << shifts, dim=-1, dtype=torch.int32)
    # bit 31 set without overflow: OR in INT32_MIN where the sign is +
    return low | (bits[..., 31] * _INT32_MIN)


def unpack_bits(words: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits` → ±1 int8 tensor of trailing dim ``d``.

    ``(w >> j) & 1`` is the bit even under int32's arithmetic shift.
    """
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., None] >> shifts) & 1
    signs = bits.to(torch.int8) * 2 - 1
    return signs.reshape(*words.shape[:-1], -1)[..., :d]


def words_from_numpy(words: np.ndarray) -> torch.Tensor:
    """``repro``'s uint32 words → the port's int32 tensor (same bytes)."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


class FloatCast(Transform):
    """fp32 → fp16/bf16 (2× compression, §4.4 "Precision 16-bit")."""

    name = "float_cast"

    def __init__(self, dtype: str = "float16"):
        super().__init__()
        if dtype not in _FLOAT_DTYPES:
            raise ValueError(f"FloatCast dtype must be one of "
                             f"{sorted(_FLOAT_DTYPES)}, got {dtype!r}")
        self.dtype_name = dtype
        self.dtype = _FLOAT_DTYPES[dtype]

    def init_config(self):
        return {"dtype": self.dtype_name}

    def encode(self, x, kind="docs"):
        return x.to(self.dtype)

    def decode(self, x):
        return x.float()

    def __call__(self, x, kind="docs"):
        return self.decode(self.encode(x, kind))

    def bits_per_dim(self, bits_in):
        return self.dtype.itemsize * 8


class Int8Quantizer(Transform):
    """Per-dimension affine int8 quantization (4× compression).

    scale_j = (max_j − min_j)/255, zero_j = min_j, fitted on the documents.
    Queries use the same codebook.
    """

    name = "int8"
    state_keys = ("scale", "zero")

    def __init__(self, percentile: float = 100.0):
        super().__init__()
        # percentile < 100 clips outliers before fitting the range
        self.percentile = float(percentile)

    def init_config(self):
        return {"percentile": self.percentile}

    def fit(self, docs, queries=None, rng=None):
        x = docs.float()
        if self.percentile >= 100.0:
            lo, hi = torch.amin(x, dim=0), torch.amax(x, dim=0)
        else:
            q = self.percentile / 100.0
            lo = torch.quantile(x, 1 - q, dim=0)
            hi = torch.quantile(x, q, dim=0)
        self.state["scale"] = torch.clamp(hi - lo, min=1e-12) / 255.0
        self.state["zero"] = lo
        self.fitted = True
        return self

    def encode(self, x, kind="docs"):
        q = torch.round((x - self.state["zero"]) / self.state["scale"])
        return torch.clamp(q, 0, 255).to(torch.uint8)

    def decode(self, q):
        return q.float() * self.state["scale"] + self.state["zero"]

    def __call__(self, x, kind="docs"):
        return self.decode(self.encode(x, kind))

    def bits_per_dim(self, bits_in):
        return 8.0


class OneBitQuantizer(Transform):
    """1-bit-per-dimension quantization with offset α (32× compression).

    ``offset=0.5`` → values ±0.5 (the paper's choice for IP similarity);
    ``offset=0.0`` → values {0, 1}.  ``encode`` emits packed int32 words.
    """

    name = "onebit"

    def __init__(self, offset: float = 0.5):
        super().__init__()
        self.offset = float(offset)

    def init_config(self):
        return {"offset": self.offset}

    def encode(self, x, kind="docs"):
        pad = (-x.shape[-1]) % 32
        if pad:
            # pad bits decode to 0 − α (sign −)
            x = torch.nn.functional.pad(x, (0, pad), value=-1.0)
        return pack_bits(x)

    def decode(self, words, d: int | None = None):
        if d is None:
            d = words.shape[-1] * 32
        return (unpack_bits(words, d) > 0).float() - self.offset

    def __call__(self, x, kind="docs"):
        return (x >= 0).float() - self.offset

    def bits_per_dim(self, bits_in):
        return 1.0


def compression_ratio(input_dim: int, transforms: list[Transform],
                      base_bits: float = 32.0) -> float:
    """Storage compression factor of a transform chain vs fp32 input."""
    dim, bits = input_dim, base_bits
    for t in transforms:
        dim = t.output_dim(dim)
        bits = t.bits_per_dim(bits)
    return (input_dim * base_bits) / (dim * bits)


def simulate_storage_bytes(n_vectors: int, input_dim: int,
                           transforms: list[Transform]) -> int:
    """Bytes that ``n_vectors`` rows take after the transform chain."""
    dim, bits = input_dim, 32.0
    for t in transforms:
        dim = t.output_dim(dim)
        bits = t.bits_per_dim(bits)
    return int(np.ceil(n_vectors * dim * bits / 8))
