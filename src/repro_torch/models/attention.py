"""Grouped-query attention with RoPE, in PyTorch: training, prefill and
KV-cache decode.

Counterpart of ``repro.models.attention``, over the same parameter trees.
Query-chunked attention keeps the (chunk × S) f32 score tile bounded at any
sequence length; ``repro``'s ``lax.scan`` over chunks is one Python loop.
Numerics are ``repro``'s: bf16 projections, scores in f32 (q and k are
upcast before the product, so only the summation order differs from
XLA's f32-accumulated bf16 product), causal masks at ``NEG_INF`` rather
than −inf, softmax in f32, and the weights cast to bf16 before P·V.
``repro``'s ``shard(...)`` annotations (the identity without a sharding
context) are left out: these are single-device functions.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models import layers as L

NEG_INF = -1e30


def attention_spec(cfg: LMConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    spec = {
        "wq": L.ParamSpec((d, cfg.n_heads, hd), ("fsdp", "heads", None)),
        "wk": L.ParamSpec((d, cfg.n_kv_heads, hd), ("fsdp", "kv_heads", None)),
        "wv": L.ParamSpec((d, cfg.n_kv_heads, hd), ("fsdp", "kv_heads", None)),
        "wo": L.ParamSpec((cfg.n_heads, hd, d), ("heads", None, "fsdp")),
    }
    if cfg.qkv_bias:
        spec["bq"] = L.ParamSpec((cfg.n_heads, hd), ("heads", None), "zeros")
        spec["bk"] = L.ParamSpec((cfg.n_kv_heads, hd), ("kv_heads", None),
                                 "zeros")
        spec["bv"] = L.ParamSpec((cfg.n_kv_heads, hd), ("kv_heads", None),
                                 "zeros")
    return spec


def _project_qkv(p: dict, x: torch.Tensor, cfg: LMConfig, dt):
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dnh->bsnh", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dnh->bsnh", x, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def _inv_sqrt(hd: int) -> float:
    """1/√hd as ``repro`` forms it, in f32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, n_kv: int) -> torch.Tensor:
    """q (B,Sq,H,hd), k (B,Sk,KV,hd) → scores (B,KV,G,Sq,Sk) float32."""
    b, sq, h, hd = q.shape
    g = h // n_kv
    qg = q.reshape(b, sq, n_kv, g, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float())
    return scores / float(np.sqrt(np.float32(hd)))


def _gqa_out(weights: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """weights (B,KV,G,Sq,Sk) × v (B,Sk,KV,hd) → (B,Sq,H,hd)."""
    b, kv, g, sq, sk = weights.shape
    o = torch.einsum("bkgst,btkh->bskgh", weights.to(v.dtype), v)
    return o.reshape(b, sq, kv * g, o.shape[-1])


def _q_chunk(cfg: LMConfig, s: int) -> int:
    """``min(attn_q_chunk or s, s)``; a sequence it does not divide is one
    chunk."""
    chunk = min(cfg.attn_q_chunk or s, s)
    return s if s % chunk else chunk


def _chunked_causal_attend(q, k, v, p, cfg: LMConfig) -> torch.Tensor:
    """Query-chunked causal attention: chunks of ``cfg.attn_q_chunk``
    queries against the full K/V, masked causally by absolute position.
    The (chunk × S) score tile bounds transient memory at any S."""
    dt = q.dtype
    s = q.shape[1]
    n_kv = cfg.n_kv_heads
    chunk = _q_chunk(cfg, s)
    kf = k.float()                      # upcast once for every chunk
    kv_pos = torch.arange(s, device=q.device)
    outs = []
    for start in range(0, s, chunk):
        scores = _gqa_scores(q[:, start:start + chunk], kf, n_kv)
        q_pos = start + torch.arange(scores.shape[-2], device=q.device)
        causal = kv_pos[None, :] <= q_pos[:, None]          # (sq, S)
        scores = torch.where(causal, scores, NEG_INF)
        outs.append(_gqa_out(torch.softmax(scores, dim=-1), v))
    o = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return torch.einsum("bsnh,nhd->bsd", o, p["wo"].to(dt))


def _online_causal_attend(q, k, v, p, cfg: LMConfig) -> torch.Tensor:
    """Flash-style attention: q-chunk × kv-chunk tiles with an online
    softmax (running max and sum carried across kv chunks, in f32; the
    weights applied in bf16).  Only the causally needed kv chunks run: a
    wholly future chunk adds exactly nothing, because chunk 0 always holds
    a valid position, so ``repro``'s scan over all of them gives the same
    values."""
    dt = q.dtype
    b, s = q.shape[0], q.shape[1]
    n_kv = cfg.n_kv_heads
    h = cfg.n_heads
    g = h // n_kv
    hd = q.shape[-1]
    cq = _q_chunk(cfg, s)
    ck = cq                             # kv chunk = q chunk
    qg = q.reshape(b, s // cq, cq, n_kv, g, hd)
    scale = _inv_sqrt(hd)
    dev = q.device
    outs = []
    for qi in range(s // cq):
        q_tile = qg[:, qi].float()
        q_pos = qi * cq + torch.arange(cq, device=dev)
        m = torch.full((b, n_kv, g, cq), NEG_INF, device=dev)
        l = torch.zeros((b, n_kv, g, cq), device=dev)
        o = torch.zeros((b, cq, n_kv, g, hd), device=dev)
        for kj in range(qi + 1):
            k_tile = k[:, kj * ck:(kj + 1) * ck].float()
            v_tile = v[:, kj * ck:(kj + 1) * ck]
            scores = torch.einsum("bskgh,btkh->bkgst", q_tile, k_tile) * scale
            kv_pos = kj * ck + torch.arange(ck, device=dev)
            causal = kv_pos[None, :] <= q_pos[:, None]
            scores = torch.where(causal, scores, NEG_INF)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            p_tile = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p_tile.sum(dim=-1)
            o = (o * corr.movedim(-1, 1)[..., None]
                 + torch.einsum("bkgst,btkh->bskgh", p_tile.to(dt),
                                v_tile).float())
            m = m_new
        o = o / l.movedim(-1, 1)[..., None]
        outs.append(o.reshape(b, cq, h, hd).to(dt))
    o = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return torch.einsum("bsnh,nhd->bsd", o, p["wo"].to(dt))


def _attend(q, k, v, p, cfg: LMConfig) -> torch.Tensor:
    if cfg.attn_impl == "online":
        return _online_causal_attend(q, k, v, p, cfg)
    return _chunked_causal_attend(q, k, v, p, cfg)


def _roped_qkv(p, x, cos, sin, cfg: LMConfig):
    s = x.shape[1]
    q, k, v = _project_qkv(p, x, cfg, x.dtype)
    return (L.apply_rope(q, cos[:s], sin[:s]),
            L.apply_rope(k, cos[:s], sin[:s]), v)


def self_attention(p: dict, x: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """Causal self-attention over the full sequence (training)."""
    q, k, v = _roped_qkv(p, x, cos, sin, cfg)
    return _attend(q, k, v, p, cfg)


def prefill_attention(p: dict, x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor, cfg: LMConfig
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Like :func:`self_attention`, but also returns (k, v) for the decode
    cache."""
    q, k, v = _roped_qkv(p, x, cos, sin, cfg)
    return _attend(q, k, v, p, cfg), k, v


def decode_attention(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos, cos: torch.Tensor,
                     sin: torch.Tensor, cfg: LMConfig,
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a (B, S, KV, hd) cache.

    ``pos`` (an int or a 0-d integer tensor) is the index of the new token,
    the same for every sequence in the batch.  Its k and v are written into
    the caches in place at ``pos`` (it must lie in ``[0, S)``: ``repro``'s
    ``dynamic_update_slice`` would clamp it); slots above ``pos`` are
    masked.  Returns (out, cache_k, cache_v).
    """
    dt = x.dtype
    b = x.shape[0]
    s_max = cache_k.shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg, dt)        # (B,1,·,hd)
    pos_t = torch.as_tensor(pos, device=x.device).long().reshape(1)
    positions = pos_t.expand(b)
    q = L.apply_rope_at(q, cos, sin, positions)
    k_new = L.apply_rope_at(k_new, cos, sin, positions)
    cache_k.index_copy_(1, pos_t, k_new.to(cache_k.dtype))
    cache_v.index_copy_(1, pos_t, v_new.to(cache_v.dtype))

    scores = _gqa_scores(q, cache_k.to(dt), cfg.n_kv_heads)
    valid = torch.arange(s_max, device=x.device)[None, :] <= pos_t
    scores = torch.where(valid, scores, NEG_INF)
    o = _gqa_out(torch.softmax(scores, dim=-1), cache_v.to(dt))
    out = torch.einsum("bsnh,nhd->bsd", o, p["wo"].to(dt))
    return out, cache_k, cache_v
