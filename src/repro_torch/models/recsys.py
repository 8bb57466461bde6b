"""Recommendation models in PyTorch: two-tower retrieval, FM, DIN, DCN-v2.

Counterpart of ``repro.models.recsys``, over the same parameter trees.
The embedding layer is a row gather (``F.embedding``: on the card its
backward sorts the ids and sums each row's gradients without atomic adds)
and a segment reduction (``index_add_`` for sums, ``scatter_reduce`` for
the max);
tables are stored *fused* (one (Σ vocab_f, dim) matrix with per-field row
offsets).  Activations run in bf16 where ``repro``'s do.  ``repro``'s
``shard(...)`` annotations (the identity without a sharding context) are
left out: these are single-device models.

Ids must lie in ``[0, rows)``; nothing checks them on the device (a check
would wait for it).  Out of range, a gather raises on the CPU and faults
on the card, where ``repro``'s ``jnp.take`` returns NaN rows; a segment id
out of range raises, where ``repro`` drops the row.

The paper's technique plugs in at the two-tower candidate index: the item
tower's embeddings of the candidates are a KB index, compressed and
searched by :mod:`repro_torch.retrieval`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import (DCNConfig, DINConfig, FMConfig,
                                      TwoTowerConfig)
from repro_torch.models import layers as L

BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# EmbeddingBag substrate
# ---------------------------------------------------------------------------


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row gather: (V, d) × (...,) int → (..., d)."""
    return F.embedding(ids, table)


def segment_sum(x: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Rows of ``x`` summed per segment, (num_segments, ...); an empty
    segment is 0.  On the card the adds are atomic: sums are not
    bit-reproducible there."""
    out = x.new_zeros((num_segments, *x.shape[1:]))
    return out.index_add(0, segment_ids, x)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  segment_ids: torch.Tensor, num_segments: int,
                  mode: str = "sum",
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ragged multi-hot pooling: gather rows, segment-reduce per bag.

    ids, segment_ids: flat (nnz,) tensors; returns (num_segments, d).  An
    empty bag is 0 under sum and mean and −inf under max, as in ``repro``.
    """
    rows = embedding_lookup(table, ids)
    if weights is not None:
        rows = rows * weights[:, None]
    if mode == "sum":
        return segment_sum(rows, segment_ids, num_segments)
    if mode == "mean":
        s = segment_sum(rows, segment_ids, num_segments)
        n = segment_sum(torch.ones_like(ids, dtype=rows.dtype), segment_ids,
                        num_segments)
        return s / torch.clamp(n[:, None], min=1.0)
    if mode == "max":
        out = rows.new_full((num_segments, rows.shape[-1]), float("-inf"))
        index = segment_ids.long()[:, None].expand(-1, rows.shape[-1])
        return out.scatter_reduce(0, index, rows, "amax", include_self=False)
    raise ValueError(mode)


def fused_field_lookup(table: torch.Tensor, ids: torch.Tensor,
                       vocab_per_field: int) -> torch.Tensor:
    """(B, F) per-field ids → (B, F, d) via a fused table with row offsets."""
    n_fields = ids.shape[-1]
    offsets = torch.arange(n_fields, dtype=ids.dtype,
                           device=ids.device) * vocab_per_field
    return embedding_lookup(table, ids + offsets)


# ---------------------------------------------------------------------------
# Two-tower retrieval (RecSys'19 YouTube-style)
# ---------------------------------------------------------------------------


def two_tower_spec(cfg: TwoTowerConfig) -> dict:
    d = cfg.embed_dim
    return {
        "user_table": L.ParamSpec((cfg.user_vocab, d), ("vocab", None),
                                  "embed", 0.02),
        "item_table": L.ParamSpec((cfg.item_vocab, d), ("vocab", None),
                                  "embed", 0.02),
        "user_tower": L.mlp_spec(
            (d * cfg.n_user_features, *cfg.tower_mlp), in_axis=None),
        "item_tower": L.mlp_spec(
            (d * cfg.n_item_features, *cfg.tower_mlp), in_axis=None),
    }


def _maybe_normalize(x: torch.Tensor, cfg: TwoTowerConfig) -> torch.Tensor:
    if not cfg.normalize:
        return x
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-9)


def _tower(table: torch.Tensor, tower: list, ids: torch.Tensor,
           cfg: TwoTowerConfig) -> torch.Tensor:
    e = embedding_lookup(table, ids)                          # (B, F, d)
    e = e.reshape(e.shape[0], -1).to(BF16)
    return _maybe_normalize(L.mlp(tower, e, act=torch.relu).float(), cfg)


def user_embedding(params: dict, user_ids: torch.Tensor,
                   cfg: TwoTowerConfig) -> torch.Tensor:
    """(B, n_user_features) hashed ids → (B, d_out) tower output."""
    return _tower(params["user_table"], params["user_tower"], user_ids, cfg)


def item_embedding(params: dict, item_ids: torch.Tensor,
                   cfg: TwoTowerConfig) -> torch.Tensor:
    return _tower(params["item_table"], params["item_tower"], item_ids, cfg)


def two_tower_loss(params: dict, batch: dict, cfg: TwoTowerConfig):
    """In-batch sampled softmax with logQ correction (Yi et al. 2019)."""
    u = user_embedding(params, batch["user_ids"], cfg)       # (B, d)
    v = item_embedding(params, batch["item_ids"], cfg)       # (B, d)
    logits = (u @ v.T) / cfg.temperature                     # (B, B)
    logq = batch.get("log_q")                                # (B,) sampling
    if logq is not None:
        logits = logits - logq[None, :]
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.diagonal(logp))
    return loss, {"softmax_ce": loss}


def two_tower_score(params: dict, batch: dict, cfg: TwoTowerConfig):
    """Serving: per-(user, item) dot scores (B,)."""
    u = user_embedding(params, batch["user_ids"], cfg)
    v = item_embedding(params, batch["item_ids"], cfg)
    return torch.sum(u * v, dim=-1)


def retrieval_scores(params: dict, batch: dict, cfg: TwoTowerConfig):
    """Retrieval: (B_q, F) users × (N_cand, F) candidates → (B_q, N_cand).

    The uncompressed oracle: the candidate embeddings it scores are what a
    compressed index is built from.
    """
    u = user_embedding(params, batch["user_ids"], cfg)
    v = item_embedding(params, batch["cand_ids"], cfg)
    return u @ v.T


# ---------------------------------------------------------------------------
# Candidate scoring (retrieval_cand shape) for the ranking models: one fixed
# user/context scored against N candidate items, batched.  For FM the
# decomposition makes this a gather + GEMV; DIN/DCN run their full
# interaction per candidate (that is the model's serving cost).
# ---------------------------------------------------------------------------


def fm_candidate_scores(params: dict, batch: dict, cfg: FMConfig):
    """batch: context_ids (1, F−1) fixed fields; cand_ids (N,) item field.

    FM scores decompose: score(ctx, item) = const(ctx) + w_item +
    ⟨Σ_f v_ctx[f], v_item⟩ — O(N·k)."""
    ctx = batch["context_ids"]                              # (1, F-1)
    cand = batch["cand_ids"]                                # (N,)
    v_ctx = fused_field_lookup(params["v"], ctx,
                               cfg.vocab_per_field)[0]      # (F-1, k)
    sum_ctx = torch.sum(v_ctx, dim=0)                       # (k,)
    # the candidate field is the last field: offset its rows
    off = (cfg.n_sparse - 1) * cfg.vocab_per_field
    v_item = embedding_lookup(params["v"], cand + off)      # (N, k)
    w_item = embedding_lookup(params["w_lin"], cand + off)[:, 0]
    const = (params["w0"][0]
             + torch.sum(fused_field_lookup(params["w_lin"], ctx,
                                            cfg.vocab_per_field)[0])
             + 0.5 * (torch.sum(sum_ctx * sum_ctx)
                      - torch.sum(v_ctx * v_ctx)))
    return const + w_item + v_item @ sum_ctx


def din_candidate_scores(params: dict, batch: dict, cfg: DINConfig):
    """batch: history_ids (1, S), context_ids (1, F), cand_ids (N,)."""
    n = batch["cand_ids"].shape[0]
    big = {
        "target_ids": batch["cand_ids"],
        "history_ids": batch["history_ids"].expand(n, cfg.seq_len),
        "context_ids": batch["context_ids"].expand(
            n, cfg.n_context_features),
    }
    return din_logits(params, big, cfg)


def dcn_candidate_scores(params: dict, batch: dict, cfg: DCNConfig):
    """batch: dense (1, n_dense), sparse_ids (1, n_sparse−1), cand_ids (N,)."""
    n = batch["cand_ids"].shape[0]
    sparse = torch.cat([batch["sparse_ids"].expand(n, cfg.n_sparse - 1),
                        batch["cand_ids"][:, None]], dim=-1)
    big = {"dense": batch["dense"].expand(n, cfg.n_dense),
           "sparse_ids": sparse}
    return dcn_logits(params, big, cfg)


# ---------------------------------------------------------------------------
# Factorization Machine (Rendle, ICDM'10)
# ---------------------------------------------------------------------------


def fm_spec(cfg: FMConfig) -> dict:
    v_total = cfg.n_sparse * cfg.vocab_per_field
    return {
        "w0": L.ParamSpec((1,), (None,), "zeros"),
        "w_lin": L.ParamSpec((v_total, 1), ("vocab", None), "embed", 0.01),
        "v": L.ParamSpec((v_total, cfg.embed_dim), ("vocab", None),
                         "embed", 0.02),
    }


def fm_logits(params: dict, batch: dict, cfg: FMConfig) -> torch.Tensor:
    """O(n·k) pairwise interactions via the sum-square trick."""
    ids = batch["sparse_ids"]                                # (B, F)
    lin = fused_field_lookup(params["w_lin"], ids,
                             cfg.vocab_per_field)[..., 0]    # (B, F)
    v = fused_field_lookup(params["v"], ids, cfg.vocab_per_field)  # (B,F,k)
    sum_v = torch.sum(v, dim=1)                              # (B, k)
    sum_sq = torch.sum(v * v, dim=1)                         # (B, k)
    pair = 0.5 * torch.sum(sum_v * sum_v - sum_sq, dim=-1)   # (B,)
    return params["w0"][0] + torch.sum(lin, dim=-1) + pair


def bce_loss(logits: torch.Tensor, labels: torch.Tensor):
    ls = F.logsigmoid(logits)
    lns = F.logsigmoid(-logits)
    loss = -torch.mean(labels * ls + (1 - labels) * lns)
    return loss, {"bce": loss}


def fm_loss(params: dict, batch: dict, cfg: FMConfig):
    return bce_loss(fm_logits(params, batch, cfg), batch["labels"])


# ---------------------------------------------------------------------------
# DIN (Deep Interest Network, arXiv:1706.06978)
# ---------------------------------------------------------------------------


def din_spec(cfg: DINConfig) -> dict:
    d = cfg.embed_dim
    ctx_total = cfg.n_context_features * cfg.context_vocab
    return {
        "item_table": L.ParamSpec((cfg.item_vocab, d), ("vocab", None),
                                  "embed", 0.02),
        "context_table": L.ParamSpec((ctx_total, d), ("vocab", None),
                                     "embed", 0.02),
        # attention MLP over [hist, target, hist−target, hist⊙target]
        "attn_mlp": L.mlp_spec((4 * d, *cfg.attn_mlp, 1), in_axis=None),
        "mlp": L.mlp_spec(
            (2 * d + cfg.n_context_features * d, *cfg.mlp, 1), in_axis=None),
    }


def din_logits(params: dict, batch: dict, cfg: DINConfig) -> torch.Tensor:
    table = params["item_table"]
    target = embedding_lookup(table, batch["target_ids"]).to(BF16)  # (B, d)
    hist = embedding_lookup(table, batch["history_ids"]).to(BF16)  # (B, S, d)
    hist_mask = batch.get("history_mask")
    t = target[:, None, :].expand_as(hist)
    feats = torch.cat([hist, t, hist - t, hist * t], dim=-1)
    w = L.mlp(params["attn_mlp"], feats, act=torch.sigmoid)[..., 0]  # (B, S)
    if hist_mask is not None:
        w = w * hist_mask.to(BF16)
    interest = torch.einsum("bs,bsd->bd", w, hist)                 # (B, d)
    ctx = embedding_lookup(params["context_table"],
                           batch["context_ids"]).to(BF16)           # (B, F, d)
    z = torch.cat([interest, target, ctx.reshape(ctx.shape[0], -1)], dim=-1)
    return L.mlp(params["mlp"], z, act=torch.relu)[..., 0].float()


def din_loss(params: dict, batch: dict, cfg: DINConfig):
    return bce_loss(din_logits(params, batch, cfg), batch["labels"])


# ---------------------------------------------------------------------------
# DCN-v2 (arXiv:2008.13535)
# ---------------------------------------------------------------------------


def dcn_spec(cfg: DCNConfig) -> dict:
    d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    v_total = cfg.n_sparse * cfg.vocab_per_field
    return {
        "table": L.ParamSpec((v_total, cfg.embed_dim), ("vocab", None),
                             "embed", 0.02),
        "cross": [
            {"w": L.ParamSpec((d0, d0), (None, "ff")),
             "b": L.ParamSpec((d0,), (None,), "zeros")}
            for _ in range(cfg.n_cross_layers)
        ],
        "mlp": L.mlp_spec((d0, *cfg.mlp, 1), in_axis=None),
    }


def dcn_logits(params: dict, batch: dict, cfg: DCNConfig) -> torch.Tensor:
    emb = fused_field_lookup(params["table"], batch["sparse_ids"],
                             cfg.vocab_per_field)               # (B, F, d)
    x0 = torch.cat([batch["dense"].to(BF16),
                    emb.reshape(emb.shape[0], -1).to(BF16)], dim=-1)  # (B, d0)
    x = x0
    for layer in params["cross"]:
        xw = x @ layer["w"].to(BF16) + layer["b"].to(BF16)
        x = x0 * xw + x                                         # cross-v2
    return L.mlp(params["mlp"], x, act=torch.relu)[..., 0].float()


def dcn_loss(params: dict, batch: dict, cfg: DCNConfig):
    return bce_loss(dcn_logits(params, batch, cfg), batch["labels"])
