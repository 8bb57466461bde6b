"""Config schema for all architecture families.

Every assigned architecture is an :class:`ArchConfig` with:
- a model config (LMConfig / SchNetConfig / recsys configs),
- its assigned input shapes (:class:`ShapeSpec`),
- a ``reduced()`` variant for CPU smoke tests (same family, tiny dims).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    ffn: str = "swiglu"                     # swiglu | squared_relu | gelu
    moe: Optional[MoEConfig] = None
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    attn_q_chunk: int = 1024                # blockwise attention chunk
    attn_impl: str = "chunked"              # chunked | online (flash-style)
    remat: str = "full"                     # none | dots | full
    logits_dtype: str = "float32"
    # tp_fsdp: heads/ff/experts over "model", params dim0 over "data" (FSDP)
    # fsdp:    pure ZeRO-3 — batch AND params over ("data","model"); right
    #          for models whose head counts don't divide the model axis
    parallel_mode: str = "tp_fsdp"
    # scan_layers=True: O(1) compile size (training default).  The dry-run
    # unrolls (False) because XLA cost_analysis counts a while-loop body
    # once — unrolled HLO gives exact FLOP/byte/collective totals.
    scan_layers: bool = True
    # CE is computed over token chunks (remat'd): the (tokens, vocab) logits
    # tensor is never materialized.  None → single pass (cost analysis).
    loss_chunk: Optional[int] = 16384
    # gradient-accumulation microbatches for the train step (TP archs whose
    # per-device batch is > 1 sequence)
    train_microbatches: int = 1
    # int8 Adam moments (optimizer-state precision reduction — the paper's
    # idea applied to training state; 8 B/param → 2 B/param)
    opt_quantized_state: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def params_dense(self) -> int:
        hd = self.resolved_head_dim
        attn = self.d_model * hd * (2 * self.n_heads + 2 * self.n_kv_heads)
        if self.ffn == "swiglu":
            ffn = 3 * self.d_model * self.d_ff
        else:
            ffn = 2 * self.d_model * self.d_ff
        if self.moe is not None:
            ffn = ffn * self.moe.n_experts + self.d_model * self.moe.n_experts
        embed = self.vocab_size * self.d_model * (1 if self.tie_embeddings
                                                  else 2)
        return self.n_layers * (attn + ffn) + embed

    def params_active(self) -> int:
        """Active parameters per token (MoE: top-k experts only)."""
        if self.moe is None:
            return self.params_dense()
        hd = self.resolved_head_dim
        attn = self.d_model * hd * (2 * self.n_heads + 2 * self.n_kv_heads)
        mult = 3 if self.ffn == "swiglu" else 2
        ffn = (mult * self.d_model * self.d_ff * self.moe.top_k
               + self.d_model * self.moe.n_experts)
        embed = self.vocab_size * self.d_model * (1 if self.tie_embeddings
                                                  else 2)
        return self.n_layers * (attn + ffn) + embed


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    d_feat_in: int = 0        # 0 → atom-type embedding; >0 → feature proj
    n_atom_types: int = 100
    task: str = "graph"       # graph (energy regression) | node (classify)
    n_classes: int = 16


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two_tower"
    embed_dim: int = 256
    tower_mlp: tuple[int, ...] = (1024, 512, 256)
    n_user_features: int = 8
    n_item_features: int = 8
    user_vocab: int = 5_000_000
    item_vocab: int = 10_000_000
    interaction: str = "dot"
    normalize: bool = True          # cosine towers
    temperature: float = 0.05       # sampled-softmax temperature


@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str = "fm"
    n_sparse: int = 39
    embed_dim: int = 10
    vocab_per_field: int = 1_000_000


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: tuple[int, ...] = (80, 40)
    mlp: tuple[int, ...] = (200, 80)
    item_vocab: int = 2_000_000
    n_context_features: int = 4
    context_vocab: int = 100_000


@dataclasses.dataclass(frozen=True)
class DCNConfig:
    name: str = "dcn_v2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    n_cross_layers: int = 3
    mlp: tuple[int, ...] = (1024, 1024, 512)
    vocab_per_field: int = 1_000_000


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (architecture × input-shape) cell of the assignment matrix."""

    name: str                 # e.g. "train_4k"
    kind: str                 # lm_train | lm_prefill | lm_decode |
    #                           gnn_full | gnn_mini | gnn_molecule |
    #                           recsys_train | recsys_serve | retrieval_cand
    dims: dict[str, int] = dataclasses.field(default_factory=dict)
    note: str = ""

    def __getitem__(self, k: str) -> int:
        return self.dims[k]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # lm | gnn | recsys
    model: Any                # LMConfig | SchNetConfig | ...
    shapes: tuple[ShapeSpec, ...]
    reduced: Any = None       # small same-family config for smoke tests
    note: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name} has no shape {name!r}; "
                       f"known: {[s.name for s in self.shapes]}")


# ---- the LM shape set shared by all five LM architectures ---------------

LM_SHAPES = (
    ShapeSpec("train_4k", "lm_train",
              {"seq_len": 4096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "lm_prefill",
              {"seq_len": 32768, "global_batch": 32}),
    ShapeSpec("decode_32k", "lm_decode",
              {"seq_len": 32768, "global_batch": 128}),
    ShapeSpec("long_500k", "lm_decode",
              {"seq_len": 524288, "global_batch": 1},
              note="full-attention archs: decode-only is O(L); 500k prefill "
                   "(the quadratic case) is skipped per DESIGN.md §3"),
)

GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "gnn_full",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
    ShapeSpec("minibatch_lg", "gnn_mini",
              {"n_nodes": 232_965, "n_edges": 114_615_892,
               "batch_nodes": 1024, "fanout1": 15, "fanout2": 10}),
    ShapeSpec("ogb_products", "gnn_full",
              {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100}),
    ShapeSpec("molecule", "gnn_molecule",
              {"n_nodes": 30, "n_edges": 64, "batch": 128}),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "recsys_train", {"batch": 65536}),
    ShapeSpec("serve_p99", "recsys_serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "recsys_serve", {"batch": 262_144}),
    ShapeSpec("retrieval_cand", "retrieval_cand",
              {"batch": 1, "n_candidates": 1_000_000}),
)
