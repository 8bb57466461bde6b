"""Transformer LM (dense and MoE) in PyTorch: training, prefill and decode.

Counterpart of ``repro.models.transformer``, over the same parameter
trees: every layer leaf keeps ``repro``'s leading L axis, so
``state_from_numpy`` and checkpoints cross between the packages unchanged.
``repro`` scans the stacked layers (or unrolls them); the port runs one
Python loop over them for both values of ``scan_layers``.  Activation
checkpointing wraps each layer: ``remat="full"`` recomputes it whole in
the backward pass, ``"dots"`` keeps the outputs of its unbatched matrix
products (the counterpart of ``dots_with_no_batch_dims_saveable``) and
recomputes the rest.  The embedding is a row gather (``F.embedding``,
whose backward sorts the ids instead of adding atomically), cast to bf16
after the gather; logits and the cross-entropy are f32.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import LMConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.parallel.sharding import ShardingContext
from repro_torch.train.optimizer import tree_map
from repro_torch.utils import DeviceLike, resolve_device

BF16 = torch.bfloat16


def _stack_specs(spec_tree: Any, n: int, axis_name: Optional[str] = None):
    """Prepend a stacked-layer dim to every ParamSpec in the tree."""
    return tree_map(lambda s: L.ParamSpec((n, *s.shape), (axis_name, *s.axes),
                                          s.init, s.scale, s.dtype),
                    spec_tree)


def ffn_spec(cfg: LMConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    spec = {"w_out": L.ParamSpec((ff, d), ("ff", "fsdp"))}
    spec["w_in"] = L.ParamSpec((d, ff), ("fsdp", "ff"))
    if cfg.ffn == "swiglu":
        spec["w_gate"] = L.ParamSpec((d, ff), ("fsdp", "ff"))
    return spec


def dense_ffn(p: dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    dt = x.dtype
    h = x @ p["w_in"].to(dt)
    if cfg.ffn == "swiglu":
        g = x @ p["w_gate"].to(dt)
        h = L.silu(g) * h
    elif cfg.ffn == "squared_relu":
        h = L.squared_relu(h)
    else:
        h = L.gelu_tanh(h)
    return h @ p["w_out"].to(dt)


def layer_spec(cfg: LMConfig) -> dict:
    spec = {
        "attn_norm": L.rmsnorm_spec(cfg.d_model),
        "attn": A.attention_spec(cfg),
        "ffn_norm": L.rmsnorm_spec(cfg.d_model),
    }
    spec["ffn"] = M.moe_spec(cfg) if cfg.moe else ffn_spec(cfg)
    return spec


def lm_spec(cfg: LMConfig) -> dict:
    spec = {
        "embed": L.ParamSpec((cfg.vocab_size, cfg.d_model),
                             ("vocab", "embed"), "embed", scale=0.02),
        "layers": _stack_specs(layer_spec(cfg), cfg.n_layers),
        "final_norm": L.rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = L.ParamSpec((cfg.d_model, cfg.vocab_size),
                                      ("embed", "vocab"), "normal")
    return spec


def init(generator: Optional[torch.Generator], cfg: LMConfig,
         device: DeviceLike = None) -> dict:
    """Parameters on ``device``.  As in ``repro``, a stacked leaf's init
    counts the L axis in its fan-in, so init statistics depend on depth."""
    return L.init_params(generator, lm_spec(cfg), device)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _layer(params: dict, i: int) -> dict:
    return tree_map(lambda p: p[i], params["layers"])


def _head(params: dict, cfg: LMConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), params["embed"]).to(BF16)


def _ffn(lp: dict, y: torch.Tensor, cfg: LMConfig
         ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's FFN on (B, S, d): dense, or MoE over the flat tokens
    (then with its aux loss)."""
    if cfg.moe:
        b, s, d = y.shape
        out, aux = M.moe_ffn(lp["ffn"], y.reshape(b * s, d), cfg)
        return out.reshape(b, s, d), aux
    return dense_ffn(lp["ffn"], y, cfg), None


def _residual_norm(p: dict, x: torch.Tensor, h: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(x + h, the RMSNorm of x + h).  The norm reads the sum in f32,
    before its bf16 rounding: XLA keeps it so where the add feeds the
    norm's f32 upcast in one fusion, as in each of ``repro``'s layers."""
    return x + h, L.rmsnorm(p, x.float() + h.float()).to(x.dtype)


def _layer_body(x: torch.Tensor, lp: dict, cos, sin, cfg: LMConfig
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One transformer block. Returns (x, aux_loss)."""
    h = A.self_attention(lp["attn"], L.rmsnorm(lp["attn_norm"], x),
                         cos, sin, cfg)
    x, y = _residual_norm(lp["ffn_norm"], x, h)
    out, aux = _ffn(lp, y, cfg)
    if aux is None:
        aux = torch.zeros((), device=x.device)
    return x + out, aux


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of matrix products without batch dims: ``mm``, and
    ``bmm`` over a batch of one (how ``einsum`` runs a projection)."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, cfg: LMConfig):
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def run(*args):
        # the recomputation runs in the backward pass, after the step's
        # ShardingContext has exited: it re-enters the forward's (mesh,
        # rules), so a MoE layer recomputes in the same dispatch groups
        ctx = ShardingContext.current()
        mesh, rules = (ctx.mesh, ctx.rules) if ctx else (None, None)

        def under_ctx(*a):
            with ShardingContext(mesh, rules):
                return fn(*a)
        return checkpoint(under_ctx, *args, use_reentrant=False, **kw)
    return run


def forward_features(params: dict, tokens: torch.Tensor, cfg: LMConfig
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (final hidden states (B, S, d), moe aux loss)."""
    s = tokens.shape[1]
    x = _embed(params, tokens)                            # (B, S, d)
    cos, sin = L.rope_angles(cfg.resolved_head_dim, s, cfg.rope_theta,
                             device=x.device)
    body = _remat_wrap(
        lambda x, lp: _layer_body(x, lp, cos, sin, cfg), cfg)
    aux = torch.zeros((), device=x.device)
    for i in range(cfg.n_layers):
        x, a = body(x, _layer(params, i))
        aux = aux + a
    return L.rmsnorm(params["final_norm"], x), aux


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, S, V) f32, moe aux loss)."""
    x, aux = forward_features(params, tokens, cfg)
    logits = torch.einsum("bsd,dv->bsv", x.float(),
                          _head(params, cfg).float())
    return logits, aux


def _ce_chunk(x_chunk: torch.Tensor, labels_chunk: torch.Tensor,
              mask_chunk: Optional[torch.Tensor], head: torch.Tensor
              ) -> torch.Tensor:
    """Sum of token NLLs for one chunk: ``logsumexp − masked-reduce(gold)``,
    as ``repro`` forms it."""
    logits = x_chunk.float() @ head.float()
    lse = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.sum(torch.where(vocab[None, :] == labels_chunk[:, None],
                                 logits, 0.0), dim=-1)
    nll = lse - gold
    if mask_chunk is not None:
        nll = nll * mask_chunk
    return torch.sum(nll)


def loss_fn(params: dict, batch: dict, cfg: LMConfig
            ) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy + MoE aux loss.

    The CE runs over chunks of ``cfg.loss_chunk`` tokens, each under
    ``checkpoint``: the (tokens, vocab) logits are never whole (a chunk's
    are recomputed in the backward pass).  ``loss_chunk=None``, or a token
    count it does not divide or exceed, is one pass.
    """
    x, aux = forward_features(params, batch["tokens"], cfg)
    b, s, d = x.shape
    head = _head(params, cfg)
    xf = x.reshape(b * s, d)
    labels = batch["labels"].reshape(b * s).long()
    mask = batch.get("mask")
    mask_f = mask.reshape(b * s) if mask is not None else None

    chunk = cfg.loss_chunk
    if chunk is None or (b * s) <= chunk or (b * s) % chunk != 0:
        nll_sum = _ce_chunk(xf, labels, mask_f, head)
    else:
        nll_sum = torch.zeros((), device=x.device)
        for c in range(0, b * s, chunk):
            nll_sum = nll_sum + checkpoint(
                _ce_chunk, xf[c:c + chunk], labels[c:c + chunk],
                None if mask_f is None else mask_f[c:c + chunk], head,
                use_reentrant=False)

    denom = (torch.clamp(torch.sum(mask_f), min=1.0) if mask_f is not None
             else b * s)
    ce = nll_sum / denom
    aux_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
    total = ce + aux_w * aux / max(cfg.n_layers, 1)
    return total, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def _last_logits(params: dict, x: torch.Tensor, cfg: LMConfig
                 ) -> torch.Tensor:
    """(B, 1, d) hidden states → (B, V) f32 logits."""
    x = L.rmsnorm(params["final_norm"], x)
    return (x.float() @ _head(params, cfg).float())[:, 0]


def prefill(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            cache_len: Optional[int] = None):
    """tokens (B, S) → (last-token logits (B, V), kv caches (L, B, S*, KV,
    hd) bf16).  ``cache_len`` pads the caches with zeros for the decode
    steps that follow."""
    b, s = tokens.shape
    s_cache = cache_len or s
    x = _embed(params, tokens)
    cos, sin = L.rope_angles(cfg.resolved_head_dim, max(s, s_cache),
                             cfg.rope_theta, device=x.device)
    ks, vs = init_cache(cfg, b, s_cache, device=x.device)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h, k, v = A.prefill_attention(
            lp["attn"], L.rmsnorm(lp["attn_norm"], x), cos, sin, cfg)
        x, y = _residual_norm(lp["ffn_norm"], x, h)
        out, _ = _ffn(lp, y, cfg)
        x = x + out
        ks[i, :, :s] = k
        vs[i, :, :s] = v
    return _last_logits(params, x[:, -1:], cfg), (ks, vs)


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=BF16,
               device: DeviceLike = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    dev = resolve_device(device)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def cache_logical_axes() -> tuple[Optional[str], ...]:
    return (None, "batch", "kv_seq", "kv_heads", None)


def decode_step(params: dict, cache: tuple[torch.Tensor, torch.Tensor],
                tokens: torch.Tensor, pos, cfg: LMConfig):
    """One decode step: tokens (B,) new token ids at position ``pos``.

    Returns (logits (B, V), cache).  The caches are updated in place: each
    layer writes its new k and v at ``pos``.
    """
    ks, vs = cache
    x = _embed(params, tokens)[:, None, :]                # (B, 1, d)
    cos, sin = L.rope_angles(cfg.resolved_head_dim, ks.shape[2],
                             cfg.rope_theta, device=x.device)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h, _, _ = A.decode_attention(
            lp["attn"], L.rmsnorm(lp["attn_norm"], x), ks[i], vs[i], pos,
            cos, sin, cfg)
        x, y = _residual_norm(lp["ffn_norm"], x, h)
        out, _ = _ffn(lp, y, cfg)
        x = x + out
    return _last_logits(params, x, cfg), (ks, vs)
