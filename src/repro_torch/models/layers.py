"""ParamSpec DSL + core layers, in PyTorch.

Counterpart of ``repro.models.layers``.  A model is described by a tree
(dicts, lists) of :class:`ParamSpec` leaves; the same tree yields (a)
initialised parameters on a device, (b) logical sharding axes, and (c)
meta tensors (shapes and dtypes, no storage) for sizing a model before
it is allocated.

Draws come from a ``torch.Generator``, not ``jax.random``, so a fresh
initialisation matches ``repro``'s in distribution only: zeros and ones
exactly, ``normal`` at std ``scale/√fan_in``, ``embed`` at std ``scale``,
``glorot`` uniform within ±``scale·√(6/(fan_in+fan_out))``.  To start
from ``repro``'s parameters, convert them with
:func:`repro_torch.train.trainer.state_from_numpy`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.train.optimizer import tree_leaves, tree_map, tree_unflatten
from repro_torch.utils import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]        # logical axis per dim
    init: str = "normal"                   # normal|zeros|ones|glorot|embed
    scale: float = 1.0
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")


def _draw(spec: ParamSpec, generator: Optional[torch.Generator],
          device: torch.device) -> torch.Tensor:
    """One parameter, drawn in place on the generator's device (f32, no
    temporaries: a 10 GB table needs 10 GB), then moved to ``device``."""
    shape = spec.shape
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=spec.dtype, device=device)
    gen_dev = generator.device if generator is not None else device
    x = torch.empty(shape, dtype=torch.float32, device=gen_dev)
    if spec.init == "normal":
        fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
        x.normal_(0.0, spec.scale / math.sqrt(fan_in), generator=generator)
    elif spec.init == "glorot":
        fan_in = int(np.prod(shape[:-1])) or 1
        limit = math.sqrt(6.0 / (fan_in + shape[-1])) * spec.scale
        x.uniform_(-limit, limit, generator=generator)
    elif spec.init == "embed":
        x.normal_(0.0, spec.scale, generator=generator)
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    return x.to(device=device, dtype=spec.dtype)


def init_params(generator: Optional[torch.Generator], spec_tree: Any,
                device: DeviceLike = None) -> Any:
    """Materialise parameters from a ParamSpec tree on ``device``,
    deterministic in ``generator`` (leaves drawn in sorted-key order)."""
    dev = resolve_device(device)
    leaves = [_draw(s, generator, dev) for s in tree_leaves(spec_tree)]
    return tree_unflatten(spec_tree, leaves)


def abstract_params(spec_tree: Any) -> Any:
    """Meta-tensor tree (shapes and dtypes, no storage)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), spec_tree)


def logical_axes(spec_tree: Any) -> Any:
    """Tree of logical-axis tuples mirroring the params tree."""
    return tree_map(lambda s: s.axes, spec_tree)


def param_count(spec_tree: Any) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_leaves(spec_tree))


# ---------------------------------------------------------------------------
# layer applications (params are plain dict leaves produced from specs)
# ---------------------------------------------------------------------------


def dense_spec(d_in: int, d_out: int, in_axis: Optional[str],
               out_axis: Optional[str], bias: bool = True,
               init: str = "normal", scale: float = 1.0) -> dict:
    spec = {"w": ParamSpec((d_in, d_out), (in_axis, out_axis), init, scale)}
    if bias:
        spec["b"] = ParamSpec((d_out,), (out_axis,), "zeros")
    return spec


def dense(p: dict, x: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    y = x.to(compute_dtype) @ p["w"].to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def rmsnorm_spec(d: int, axis: Optional[str] = None) -> dict:
    return {"scale": ParamSpec((d,), (axis,), "ones")}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


def layernorm_spec(d: int, axis: Optional[str] = None) -> dict:
    return {"scale": ParamSpec((d,), (axis,), "ones"),
            "bias": ParamSpec((d,), (axis,), "zeros")}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def mlp_spec(dims: Sequence[int], in_axis=None, hidden_axis="ff",
             bias: bool = True) -> list:
    specs = []
    for i in range(len(dims) - 1):
        a_in = in_axis if i == 0 else hidden_axis
        a_out = hidden_axis if i < len(dims) - 2 else None
        specs.append(dense_spec(dims[i], dims[i + 1], a_in, a_out, bias))
    return specs


def mlp(p: list, x: torch.Tensor, act: Callable = torch.relu,
        compute_dtype=torch.bfloat16) -> torch.Tensor:
    for i, layer in enumerate(p):
        x = dense(layer, x, compute_dtype)
        if i < len(p) - 1:
            x = act(x)
    return x


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_angles(head_dim: int, max_len: int, theta: float = 10_000.0,
                device: DeviceLike = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    dev = resolve_device(device)
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=dev) / head_dim))
    pos = torch.arange(max_len, dtype=torch.float32, device=dev)
    ang = torch.outer(pos, freqs)                      # (S, hd/2)
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor
            ) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., S, n, head_dim); cos/sin: (S, head_dim/2)."""
    return _rotate(x, cos[:, None, :].to(x.dtype),
                   sin[:, None, :].to(x.dtype))


def apply_rope_at(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """Decode-time rope: positions (B,) for single-token queries
    x (B, 1, n, hd)."""
    return _rotate(x, cos[positions][:, None, None, :].to(x.dtype),
                   sin[positions][:, None, None, :].to(x.dtype))


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    """Primer/nemotron activation."""
    r = torch.relu(x)
    return r * r
