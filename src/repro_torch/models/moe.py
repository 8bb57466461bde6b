"""Mixture-of-Experts FFN with grouped, sort-based token dispatch, in
PyTorch.

Counterpart of ``repro.models.moe``, over the same parameter trees.  Each
group stably sorts its own tokens by assigned expert, finds positions
within each expert with a ``searchsorted`` prefix, and drops tokens past
an expert's per-group capacity into a sacrificial slot that is cut off.
The groups are the data-parallel shards: as many as the active
:class:`~repro_torch.parallel.sharding.ShardingContext`'s "batch" axes
have positions, one without a context, as in ``repro``.

Tie orders are ``repro``'s: the router's top-k gives a tie to the lowest
expert (a stable descending sort, where ``torch.topk`` promises no order),
and the dispatch sort is stable, so the capacity drop keeps each expert's
first tokens.  The combine adds each token's k weighted outputs in bf16 in
the order ``repro``'s scatter-add visits them, through the inverse
permutation of the dispatch sort: no atomic adds, so a forward repeats bit
for bit on the card.

The load-balancing auxiliary loss is Switch's (f·P, scaled by E).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.models import layers as L
from repro_torch.parallel.sharding import ShardingContext


def moe_spec(cfg: LMConfig) -> dict:
    moe = cfg.moe
    d, ff, e = cfg.d_model, cfg.d_ff, moe.n_experts
    spec = {
        "router": L.ParamSpec((d, e), (None, "experts"), "normal"),
        "w_out": L.ParamSpec((e, ff, d), ("experts", "ff", "fsdp")),
        "w_in": L.ParamSpec((e, d, ff), ("experts", "fsdp", "ff")),
    }
    if cfg.ffn == "swiglu":
        spec["w_gate"] = L.ParamSpec((e, d, ff), ("experts", "fsdp", "ff"))
    return spec


def _activation(cfg: LMConfig, h: torch.Tensor,
                g: Optional[torch.Tensor]) -> torch.Tensor:
    """SwiGLU, squared ReLU, or GELU in its tanh form."""
    if cfg.ffn == "swiglu":
        return L.silu(g) * h
    if cfg.ffn == "squared_relu":
        return L.squared_relu(h)
    return L.gelu_tanh(h)


def load_balance_loss(probs: torch.Tensor, expert_ids: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E · Σ_e f_e · P_e (over all tokens)."""
    f = torch.mean(F.one_hot(expert_ids.long(), n_experts).float(),
                   dim=tuple(range(expert_ids.ndim)))
    p = torch.mean(probs.float(), dim=tuple(range(probs.ndim - 1)))
    return n_experts * torch.sum(f * p)


def _n_groups(t: int) -> int:
    """Dispatch groups = data-parallel shards: the product of the active
    context's "batch" mesh axes, halved until it divides ``t`` (1 without
    a mesh)."""
    ctx = ShardingContext.current()
    if ctx is None or ctx.mesh is None or ctx.rules is None:
        return 1
    ax = ctx.rules.get("batch")
    if ax is None:
        return 1
    axes = (ax,) if isinstance(ax, str) else ax
    g = 1
    for a in axes:
        g *= ctx.mesh.shape.get(a, 1)
    while g > 1 and t % g != 0:
        g //= 2
    return max(g, 1)


def _router_top_k(probs: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest probabilities per token, ties to the lowest expert."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _dispatch(x: torch.Tensor, expert_ids: torch.Tensor,
              gate: torch.Tensor, capacity: int, e: int, dt):
    """Every group's sort-based dispatch at once, each group on its own:
    x (G, Tg, d); ids/gate (G, Tg, k).  Returns (buf (G, E, C, d),
    combine metadata)."""
    g, tg, d = x.shape
    k = expert_ids.shape[-1]
    dev = x.device
    flat_e = expert_ids.reshape(g, -1)                     # (G, Tg·k)
    sort_idx = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, sort_idx)
    token_of = sort_idx // k
    first_occ = torch.searchsorted(
        sorted_e, torch.arange(e, device=dev,
                               dtype=sorted_e.dtype).expand(g, e).contiguous())
    pos = torch.arange(tg * k, device=dev) - torch.gather(first_occ, 1,
                                                          sorted_e)
    keep = pos < capacity
    slot = torch.where(keep, pos, capacity)   # dropped → sacrificial slot
    group = torch.arange(g, device=dev)[:, None].expand_as(sorted_e)

    buf = torch.zeros((g, e, capacity + 1, d), dtype=dt, device=dev)
    # only the sacrificial slot takes duplicate indices, and it is cut off
    buf = buf.index_put((group, sorted_e, slot), x[group, token_of])
    buf = buf[:, :, :capacity]
    gate_sorted = torch.gather(gate.reshape(g, -1), 1, sort_idx).to(dt)
    return buf, (sort_idx, sorted_e, slot, keep, gate_sorted)


def _combine(out_buf: torch.Tensor, meta, tg: int, dt) -> torch.Tensor:
    """Weighted expert outputs back to each group's tokens: out_buf
    (G, E, C, d) → (G, Tg, d).  ``repro`` scatter-adds them in bf16; here
    each token's k outputs are added one after another in the order that
    scatter visits them (the dispatch order, by expert), each add rounded
    to ``dt``: the same sums, made without atomic adds."""
    sort_idx, sorted_e, slot, keep, gate_sorted = meta
    g, n = sort_idx.shape
    dev = out_buf.device
    padded = F.pad(out_buf, (0, 0, 0, 1))                  # (G, E, C+1, d)
    group = torch.arange(g, device=dev)[:, None].expand_as(sorted_e)
    vals = padded[group, sorted_e, slot]                   # (G, Tg·k, d)
    vals = vals * gate_sorted[..., None] * keep.to(dt)[..., None]
    rank = torch.empty_like(sort_idx)                      # inverse perm.
    rank.scatter_(1, sort_idx, torch.arange(n, device=dev).expand(g, n))
    visits = torch.sort(rank.reshape(g, tg, -1), dim=2).values  # (G, Tg, k)
    out = torch.zeros((g, tg, out_buf.shape[-1]), dtype=dt, device=dev)
    rows = torch.arange(g, device=dev)[:, None]
    for j in range(visits.shape[2]):
        out = out + vals[rows, visits[:, :, j]]
    return out


def _dispatch_group(x: torch.Tensor, expert_ids: torch.Tensor,
                    gate: torch.Tensor, capacity: int, e: int, dt):
    """One group's dispatch (``repro``'s unit): x (Tg, d); ids/gate
    (Tg, k) → (buf (E, C, d), combine metadata)."""
    buf, meta = _dispatch(x[None], expert_ids[None], gate[None], capacity,
                          e, dt)
    return buf[0], tuple(m[0] for m in meta)


def _combine_group(out_buf: torch.Tensor, meta, tg: int, dt
                   ) -> torch.Tensor:
    """One group's combine: out_buf (E, C, d) → (Tg, d)."""
    return _combine(out_buf[None], tuple(m[None] for m in meta), tg, dt)[0]


def moe_ffn(p: dict, x: torch.Tensor, cfg: LMConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) flat tokens → (out (T, d), aux_loss scalar)."""
    moe = cfg.moe
    t, d = x.shape
    e, k = moe.n_experts, moe.top_k
    dt = x.dtype
    g = _n_groups(t)
    tg = t // g

    # --- routing (f32)
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    gate, expert_ids = _router_top_k(probs, k)                # (T, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    aux = load_balance_loss(probs, expert_ids[:, 0], e)

    capacity = max(1, int(moe.capacity_factor * tg * k / e))

    # --- per-group dispatch, all groups at once
    buf, meta = _dispatch(x.reshape(g, tg, d), expert_ids.reshape(g, tg, k),
                          gate.reshape(g, tg, k), capacity, e, dt)

    # --- expert GEMMs
    h = torch.einsum("gecd,edf->gecf", buf, p["w_in"].to(dt))
    gg = (torch.einsum("gecd,edf->gecf", buf, p["w_gate"].to(dt))
          if "w_gate" in p else None)
    h = _activation(cfg, h, gg)
    out_buf = torch.einsum("gecf,efd->gecd", h, p["w_out"].to(dt))

    # --- combine
    out = _combine(out_buf, meta, tg, dt)
    return out.reshape(t, d), aux.float()
