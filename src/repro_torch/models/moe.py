"""Mixture-of-Experts FFN with grouped, sort-based token dispatch, in
PyTorch.

Counterpart of ``repro.models.moe``, over the same parameter trees.  Each
group stably sorts its own tokens by assigned expert, finds positions
within each expert with a ``searchsorted`` prefix, and drops tokens past
an expert's per-group capacity into a sacrificial slot that is cut off.
There is one group until the port has a sharding context (``repro``'s
groups are the data-parallel shards); the group axis stays, so a mesh
only has to supply their number.

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
    """Dispatch groups: 1 (no sharding context in the port yet)."""
    return 1


def _router_top_k(probs: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest probabilities per token, ties to the lowest expert."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _dispatch_group(x: torch.Tensor, expert_ids: torch.Tensor,
                    gate: torch.Tensor, capacity: int, e: int, dt):
    """One group's sort-based dispatch.  x (Tg, d); ids/gate (Tg, k).
    Returns (buf (E, C, d), combine metadata)."""
    tg, d = x.shape
    k = expert_ids.shape[-1]
    dev = x.device
    flat_e = expert_ids.reshape(-1)                        # (Tg·k,)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    token_of = sort_idx // k
    first_occ = torch.searchsorted(sorted_e,
                                   torch.arange(e, device=dev,
                                                dtype=sorted_e.dtype))
    pos = torch.arange(tg * k, device=dev) - first_occ[sorted_e]
    keep = pos < capacity
    slot = torch.where(keep, pos, capacity)   # dropped → sacrificial slot

    buf = torch.zeros((e, capacity + 1, d), dtype=dt, device=dev)
    # only the sacrificial slot takes duplicate indices, and it is cut off
    buf = buf.index_put((sorted_e, slot), F.embedding(token_of, x))
    buf = buf[:, :capacity]
    gate_sorted = gate.reshape(-1)[sort_idx].to(dt)
    return buf, (sort_idx, sorted_e, slot, keep, gate_sorted)


def _combine_group(out_buf: torch.Tensor, meta, tg: int, dt
                   ) -> torch.Tensor:
    """Weighted expert outputs back to the group's tokens.  ``repro``
    scatter-adds them in bf16; here each token's k outputs are added one
    after another in the order that scatter visits them (the dispatch
    order, by expert), each add rounded to ``dt``: the same sums, made
    without atomic adds."""
    sort_idx, sorted_e, slot, keep, gate_sorted = meta
    padded = F.pad(out_buf, (0, 0, 0, 1))                  # (E, C+1, d)
    vals = padded[sorted_e, slot]
    vals = vals * gate_sorted[:, None] * keep.to(dt)[:, None]
    rank = torch.empty_like(sort_idx)                      # inverse perm.
    rank[sort_idx] = torch.arange(sort_idx.numel(), device=sort_idx.device)
    visits = torch.sort(rank.reshape(tg, -1), dim=1).values   # (Tg, k)
    out = torch.zeros((tg, out_buf.shape[-1]), dtype=dt,
                      device=out_buf.device)
    for j in range(visits.shape[1]):
        out = out + vals[visits[:, j]]
    return out


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

    # --- per-group dispatch
    groups = [_dispatch_group(xx, ii, gg, capacity, e, dt) for xx, ii, gg in
              zip(x.reshape(g, tg, d), expert_ids.reshape(g, tg, k),
                  gate.reshape(g, tg, k))]
    buf = torch.stack([b for b, _ in groups])                 # (G, E, C, d)

    # --- expert GEMMs
    h = torch.einsum("gecd,edf->gecf", buf, p["w_in"].to(dt))
    gg = (torch.einsum("gecd,edf->gecf", buf, p["w_gate"].to(dt))
          if "w_gate" in p else None)
    h = _activation(cfg, h, gg)
    out_buf = torch.einsum("gecf,efd->gecd", h, p["w_out"].to(dt))

    # --- combine
    out = torch.stack([_combine_group(ob, meta, tg, dt)
                       for ob, (_, meta) in zip(out_buf, groups)])
    return out.reshape(t, d), aux.float()
