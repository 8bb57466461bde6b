"""Step builder: (architecture × shape × mesh) → step bundle.

Counterpart of ``repro.launch.steps``.  For every cell of the assignment
matrix this produces:

- ``fn``            : the step (train_step / serve_step / search), a plain
                      function of tensors;
- ``abstract_args`` : meta-tensor trees (state/params + batch), from the
                      ParamSpec trees and ``data.batches.input_specs``;
- ``in_specs``      : :class:`~repro_torch.parallel.sharding.PartitionSpec`
                      trees derived from logical axes + rules;
- ``donate``        : argument indices the step may overwrite (state,
                      caches).

The same builder serves the CPU smoke tests (``reduced=True``, no mesh),
the card, and the dry run (FULL dims over meta tensors on the production
mesh), so shapes cannot drift between them.  The port is one controller
that holds every tensor whole: a spec sizes what one mesh position would
hold (:meth:`StepBundle.per_device_arg_bytes`), and the models run under
``ShardingContext(mesh, rules)`` so the MoE dispatches in the mesh's
groups.  The KB search step is the paper's own production path and runs
its shards one after another on the kernels (``int8_ip`` / ``binary_ip``
and ``topk_blocks``), then merges their candidates, counting the merge's
bytes as its all-gather.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import (ArchConfig, DCNConfig, DINConfig,
                                      FMConfig, LMConfig, SchNetConfig,
                                      ShapeSpec, TwoTowerConfig)
from repro_torch.data import batches as B
from repro_torch.kernels.binary_ip.ops import binary_ip_scores
from repro_torch.kernels.int8_ip.kernel import int8_ip
from repro_torch.models import gnn as G
from repro_torch.models import layers as L
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.parallel.collectives import COUNTER
from repro_torch.parallel.sharding import (SINGLE_POD_RULES, AxisRules,
                                           PartitionSpec as P,
                                           ShardingContext, spec_for_shape,
                                           spec_shards)
from repro_torch.retrieval.topk import (_exact_topk, topk_in_order,
                                       topk_score_then_id)
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import trainer
from repro_torch.utils import cdiv, first_divisor_leq


@dataclasses.dataclass
class StepBundle:
    name: str
    fn: Callable
    abstract_args: tuple
    in_specs: tuple              # PartitionSpec trees (no mesh → P())
    donate: tuple = ()
    model_flops_fn: Optional[Callable] = None   # per-step useful FLOPs
    #: the step performs its cross-shard collectives itself and counts
    #: their bytes; elsewhere XLA would insert them and the port has none
    counts_collectives: bool = False

    def per_device_arg_bytes(self, mesh) -> int:
        """Bytes of the arguments one mesh position holds: each tensor's
        bytes over its spec's shard count (exact: the specs only shard
        dims that divide)."""
        total = 0

        def walk(x, spec):
            nonlocal total
            if isinstance(x, torch.Tensor):
                n = x.numel() * x.element_size()
                total += n // (spec_shards(spec, mesh) if mesh else 1)
            elif isinstance(x, dict):
                for k, v in x.items():
                    walk(v, spec[k])
            elif isinstance(x, (list, tuple)):
                for i, v in enumerate(x):
                    walk(v, spec[i])

        walk(self.abstract_args, self.in_specs)
        return total


# ---------------------------------------------------------------------------
# sharding-spec helpers
# ---------------------------------------------------------------------------


def _tree_specs(spec_tree, rules: AxisRules, mesh):
    """ParamSpec tree → PartitionSpec tree."""
    return opt_lib.tree_map(
        lambda s: spec_for_shape(s.shape, s.axes, rules, mesh), spec_tree)


def _flat_with_paths(tree, path: tuple = ()):
    """(path, leaf) pairs in ``tree_leaves`` order; path keys as
    ``jax.tree_util`` prints them (a named tuple's field as ``.name``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_with_paths(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        fields = getattr(tree, "_fields", None)
        for i, v in enumerate(tree):
            key = f".{fields[i]}" if fields else str(i)
            yield from _flat_with_paths(v, path + (key,))
    else:
        yield "/".join(path), tree


def _suffix_match_specs(abstract_tree: Any, param_specs_by_path: dict
                        ) -> Any:
    """Match optimizer-state leaves to param specs by path suffix."""
    out = []
    for key, leaf in _flat_with_paths(abstract_tree):
        best, best_len = P(), -1
        for ppath, spec in param_specs_by_path.items():
            if key.endswith(ppath) and len(ppath) > best_len:
                best, best_len = spec, len(ppath)
        if not isinstance(leaf, torch.Tensor) or leaf.ndim == 0:
            best = P()
        out.append(best)
    return opt_lib.tree_unflatten(abstract_tree, out)


def _flat_param_specs(spec_tree, rules, mesh) -> dict:
    return {path: spec_for_shape(s.shape, s.axes, rules, mesh)
            for path, s in _flat_with_paths(spec_tree)}


def _batch_specs(batch_struct: dict, rules, mesh, kind: str) -> dict:
    """Logical axes for batch arrays, per shape kind."""
    def logical(name: str, s) -> tuple:
        if name == "edge_index":
            return (None, "batch")           # shard the edge axis
        if name == "cand_ids":
            return ("kb_docs",) + (None,) * (len(s.shape) - 1)
        if name == "queries":
            return ("batch", None)
        return ("batch",) + (None,) * (len(s.shape) - 1)

    return {k: spec_for_shape(v.shape, logical(k, v), rules, mesh)
            for k, v in batch_struct.items()}


def _abstract_params(spec_tree, dtype=None):
    """Meta tensors for a ParamSpec tree; ``dtype`` replaces float dtypes."""
    def f(s: L.ParamSpec):
        dt = dtype if (dtype is not None and s.dtype.is_floating_point) \
            else s.dtype
        return torch.empty(s.shape, dtype=dt, device="meta")
    return opt_lib.tree_map(f, spec_tree)


def _train_state_specs(spec_tree, state, rules, mesh) -> dict:
    return {"params": _tree_specs(spec_tree, rules, mesh),
            "opt": _suffix_match_specs(
                state["opt"], _flat_param_specs(spec_tree, rules, mesh)),
            "step": P()}


# ---------------------------------------------------------------------------
# per-family builders
# ---------------------------------------------------------------------------


def _apply_parallel_mode(rules: AxisRules, cfg: LMConfig, mesh) -> AxisRules:
    """Adjust logical rules for the arch's parallelism mode.

    "fsdp" (pure ZeRO-3): batch and parameter dim-0 shard over the whole
    mesh; no tensor parallelism (for models whose head counts don't divide
    the model axis).  "tp_fsdp" keeps the default rules.
    """
    if cfg.parallel_mode != "fsdp" or mesh is None:
        return rules
    full = tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)
    return rules.replace(batch=full, fsdp=full, heads=None, kv_heads=None,
                         ff=None, experts=None, vocab=full)


def _ctx_loss(loss_fn, cfg, mesh, rules, params, batch):
    with ShardingContext(mesh, rules):
        return loss_fn(params, batch, cfg)


def _lm_train_bundle(arch, shape, rules, mesh, reduced,
                     unroll=False) -> StepBundle:
    cfg: LMConfig = arch.reduced if reduced else arch.model
    if unroll:
        # ``repro``'s cost pass: layers and the attention q-chunk loop
        # unrolled, one macrobatch (the same FLOPs)
        dims_u = B.shape_dims(shape, reduced)
        cfg = dataclasses.replace(cfg, scan_layers=False,
                                  attn_q_chunk=min(4096, dims_u["seq_len"]),
                                  loss_chunk=None)
    rules = _apply_parallel_mode(rules, cfg, mesh)
    spec_tree = T.lm_spec(cfg)
    tx = opt_lib.OptimizerConfig(
        lr=3e-4, weight_decay=0.1, total_steps=10000,
        quantized_state=cfg.opt_quantized_state).build()
    state = trainer.abstract_state(_abstract_params(spec_tree), tx)
    batch = B.input_specs(arch, shape, reduced)

    loss = functools.partial(_ctx_loss, T.loss_fn, cfg, mesh, rules)
    dims = B.shape_dims(shape, reduced)
    micro = 1 if unroll else cfg.train_microbatches
    if dims["global_batch"] % max(micro, 1) != 0:
        micro = 1
    step = trainer.make_train_step(loss, tx, microbatches=micro)

    tokens = dims["global_batch"] * dims["seq_len"]
    return StepBundle(
        name=f"{arch.name}:{shape.name}", fn=step,
        abstract_args=(state, batch),
        in_specs=(_train_state_specs(spec_tree, state, rules, mesh),
                  _batch_specs(batch, rules, mesh, shape.kind)),
        donate=(0,), model_flops_fn=lambda: 6 * cfg.params_active() * tokens)


def _lm_prefill_bundle(arch, shape, rules, mesh, reduced,
                       unroll=False) -> StepBundle:
    cfg: LMConfig = arch.reduced if reduced else arch.model
    if unroll:
        dims_u = B.shape_dims(shape, reduced)
        cfg = dataclasses.replace(cfg, scan_layers=False,
                                  attn_q_chunk=min(4096, dims_u["seq_len"]))
    rules = _apply_parallel_mode(rules, cfg, mesh)
    spec_tree = T.lm_spec(cfg)
    params = _abstract_params(spec_tree, dtype=torch.bfloat16)
    batch = B.input_specs(arch, shape, reduced)

    def serve_prefill(params, batch):
        with ShardingContext(mesh, rules):
            return T.prefill(params, batch["tokens"], cfg)

    dims = B.shape_dims(shape, reduced)
    tokens = dims["global_batch"] * dims["seq_len"]
    return StepBundle(
        name=f"{arch.name}:{shape.name}", fn=serve_prefill,
        abstract_args=(params, batch),
        in_specs=(_tree_specs(spec_tree, rules, mesh),
                  _batch_specs(batch, rules, mesh, shape.kind)),
        model_flops_fn=lambda: 2 * cfg.params_active() * tokens)


def _lm_decode_bundle(arch, shape, rules, mesh, reduced,
                      unroll=False) -> StepBundle:
    cfg: LMConfig = arch.reduced if reduced else arch.model
    if unroll:
        cfg = dataclasses.replace(cfg, scan_layers=False)
    dims = B.shape_dims(shape, reduced)
    b, s = dims["global_batch"], dims["seq_len"]

    # Decode KV caches are the dominant state: shard batch over "data" and
    # the cache *sequence* axis over "model" (GQA kv-head counts rarely
    # divide the model axis).  For tiny batches (long_500k: b=1) the whole
    # mesh shards the sequence axis (flash-decoding's split-K schedule).
    if mesh is not None:
        data_size = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
        if b % max(data_size, 1) != 0:
            pod = ("pod",) if "pod" in mesh.axis_names else ()
            rules = rules.replace(kv_seq=pod + ("data", "model"), batch=None,
                                  heads=None, kv_heads=None, ff=None,
                                  experts=None)
        else:
            # heads never shard at decode (kv_seq owns the model axis in
            # attention); FFN/experts keep tensor/expert parallelism.
            rules = rules.replace(batch=(("pod", "data")
                                         if "pod" in mesh.axis_names
                                         else "data"),
                                  kv_seq="model", heads=None, kv_heads=None)
            if cfg.parallel_mode == "fsdp":
                rules = rules.replace(ff=None, experts=None)

    spec_tree = T.lm_spec(cfg)
    params = _abstract_params(spec_tree, dtype=torch.bfloat16)
    batch = B.input_specs(arch, shape, reduced)
    cache_shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = tuple(torch.empty(cache_shape, dtype=torch.bfloat16,
                              device="meta") for _ in range(2))
    cache_spec = spec_for_shape(cache_shape, T.cache_logical_axes(),
                                rules, mesh)
    pos = s - 1   # decode the last slot: worst-case attention span

    def serve_decode(params, cache, batch):
        with ShardingContext(mesh, rules):
            return T.decode_step(params, cache, batch["tokens"], pos, cfg)

    flops = lambda: 2 * cfg.params_active() * b \
        + 2 * cfg.n_layers * b * s * cfg.n_kv_heads \
        * cfg.resolved_head_dim * 2 * (cfg.n_heads // cfg.n_kv_heads)

    return StepBundle(
        name=f"{arch.name}:{shape.name}", fn=serve_decode,
        abstract_args=(params, cache, batch),
        in_specs=(_tree_specs(spec_tree, rules, mesh),
                  (cache_spec, cache_spec),
                  _batch_specs(batch, rules, mesh, shape.kind)),
        donate=(1,), model_flops_fn=flops)


def _gnn_bundle(arch, shape, rules, mesh, reduced) -> StepBundle:
    cfg: SchNetConfig = arch.reduced if reduced else arch.model
    dims = B.shape_dims(shape, reduced)
    if shape.kind in ("gnn_full", "gnn_mini"):
        d_feat = dims.get("d_feat", 602)
        task, n_classes = "node", 64
    else:
        d_feat, task, n_classes = 0, "graph", cfg.n_classes
    cfg = dataclasses.replace(cfg, d_feat_in=d_feat, task=task,
                              n_classes=n_classes)

    spec_tree = G.schnet_spec(cfg)
    tx = opt_lib.OptimizerConfig(lr=1e-3, total_steps=10000).build()
    state = trainer.abstract_state(_abstract_params(spec_tree), tx)
    batch = B.input_specs(arch, shape, reduced)

    loss = functools.partial(_ctx_loss, G.loss_fn, cfg, mesh, rules)
    step = trainer.make_train_step(loss, tx)

    n_edges = batch["edge_index"].shape[1]
    n_nodes = batch["positions"].shape[0]
    flops = lambda: (cfg.n_interactions
                     * (2 * n_edges * cfg.n_rbf * cfg.d_hidden
                        + 2 * n_edges * cfg.d_hidden ** 2
                        + 4 * n_nodes * cfg.d_hidden ** 2) * 3)  # fwd+bwd ~3×

    return StepBundle(
        name=f"{arch.name}:{shape.name}", fn=step,
        abstract_args=(state, batch),
        in_specs=(_train_state_specs(spec_tree, state, rules, mesh),
                  _batch_specs(batch, rules, mesh, shape.kind)),
        donate=(0,), model_flops_fn=flops)


_RECSYS = {
    TwoTowerConfig: (R.two_tower_spec, R.two_tower_loss, R.two_tower_score),
    FMConfig: (R.fm_spec, R.fm_loss, R.fm_logits),
    DINConfig: (R.din_spec, R.din_loss, R.din_logits),
    DCNConfig: (R.dcn_spec, R.dcn_loss, R.dcn_logits),
}


def _recsys_bundle(arch, shape, rules, mesh, reduced) -> StepBundle:
    cfg = arch.reduced if reduced else arch.model
    spec_fn, loss_fn, score_fn = _RECSYS[type(cfg)]
    spec_tree = spec_fn(cfg)
    batch = B.input_specs(arch, shape, reduced)
    param_specs = _tree_specs(spec_tree, rules, mesh)
    batch_specs = _batch_specs(batch, rules, mesh, shape.kind)
    dims = B.shape_dims(shape, reduced)
    name = f"{arch.name}:{shape.name}"

    if shape.kind == "recsys_train":
        tx = opt_lib.OptimizerConfig(lr=1e-3, total_steps=10000).build()
        state = trainer.abstract_state(_abstract_params(spec_tree), tx)
        loss = functools.partial(_ctx_loss, loss_fn, cfg, mesh, rules)
        return StepBundle(
            name=name, fn=trainer.make_train_step(loss, tx),
            abstract_args=(state, batch),
            in_specs=(_train_state_specs(spec_tree, state, rules, mesh),
                      batch_specs),
            donate=(0,), model_flops_fn=_recsys_flops(cfg, dims, train=True))

    if shape.kind == "recsys_serve":
        def serve(params, batch):
            with ShardingContext(mesh, rules):
                return score_fn(params, batch, cfg)

        return StepBundle(
            name=name, fn=serve,
            abstract_args=(_abstract_params(spec_tree), batch),
            in_specs=(param_specs, batch_specs),
            model_flops_fn=_recsys_flops(cfg, dims, train=False))

    if shape.kind == "retrieval_cand":
        n_cand = dims["n_candidates"]
        k_top = min(100, n_cand)

        if isinstance(cfg, TwoTowerConfig):
            cand_fn = R.retrieval_scores
            d = cfg.embed_dim
            tower = sum(a * b for a, b in zip(
                (d * cfg.n_item_features,) + cfg.tower_mlp[:-1],
                cfg.tower_mlp))
            flops = lambda: 2 * n_cand * (tower + cfg.tower_mlp[-1]
                                          * dims["batch"])
        elif isinstance(cfg, FMConfig):
            cand_fn = R.fm_candidate_scores
            flops = lambda: 2 * n_cand * cfg.embed_dim
        elif isinstance(cfg, DINConfig):
            cand_fn = R.din_candidate_scores
            per = _recsys_flops(cfg, {"batch": 1}, train=False)
            flops = lambda: n_cand * per()
        else:
            cand_fn = R.dcn_candidate_scores
            per = _recsys_flops(cfg, {"batch": 1}, train=False)
            flops = lambda: n_cand * per()

        def retrieve(params, batch):
            with ShardingContext(mesh, rules):
                scores = cand_fn(params, batch, cfg)
                if scores.ndim == 1:
                    scores = scores[None, :]
                ids = torch.arange(scores.shape[-1], dtype=torch.int32,
                                   device=scores.device)
                return topk_score_then_id(scores, ids.expand_as(scores),
                                          k_top)

        return StepBundle(
            name=name, fn=retrieve,
            abstract_args=(_abstract_params(spec_tree), batch),
            in_specs=(param_specs, batch_specs), model_flops_fn=flops)

    raise ValueError(shape.kind)


def _recsys_flops(cfg, dims, train: bool):
    mult = 6 if train else 2
    b = dims["batch"]

    def f():
        if isinstance(cfg, TwoTowerConfig):
            d = cfg.embed_dim
            tower_dims = (d * cfg.n_user_features,) + cfg.tower_mlp
            tower = sum(a * o for a, o in zip(tower_dims, tower_dims[1:]))
            per = 2 * tower + (b if train else 1) * cfg.tower_mlp[-1]
        elif isinstance(cfg, FMConfig):
            per = 3 * cfg.n_sparse * cfg.embed_dim
        elif isinstance(cfg, DINConfig):
            d = cfg.embed_dim
            attn_dims = (4 * d,) + cfg.attn_mlp + (1,)
            attn = sum(a * o for a, o in zip(attn_dims, attn_dims[1:]))
            mlp_dims = ((2 + cfg.n_context_features) * d,) + cfg.mlp + (1,)
            mlp = sum(a * o for a, o in zip(mlp_dims, mlp_dims[1:]))
            per = cfg.seq_len * attn + mlp
        else:  # DCN
            d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
            cross = cfg.n_cross_layers * d0 * d0
            mlp_dims = (d0,) + cfg.mlp + (1,)
            mlp = sum(a * o for a, o in zip(mlp_dims, mlp_dims[1:]))
            per = cross + mlp
        return mult * b * per

    return f


# ---------------------------------------------------------------------------
# the paper's KB search step
# ---------------------------------------------------------------------------


def kb_doc_axes(rules: AxisRules, mesh) -> tuple[str, ...]:
    """The mesh axes the KB's rows are sharded over (row-major shard ids)."""
    if mesh is None:
        return ()
    ax = rules.get("kb_docs")
    axes = (ax,) if isinstance(ax, str) else tuple(ax or ())
    return tuple(a for a in axes if a in mesh.axis_names)


def encode_kb_queries(index: dict, q: torch.Tensor) -> torch.Tensor:
    """The pre+post recipe's query side: center, normalise, project,
    center, normalise (rsqrt of Σ + 1e-24, as ``repro``)."""
    y = q - index["mu1"]
    y = y * torch.rsqrt(torch.sum(y * y, -1, keepdim=True) + 1e-24)
    z = y @ index["w"] - index["mu2"]
    return z * torch.rsqrt(torch.sum(z * z, -1, keepdim=True) + 1e-24)


def make_kb_scorer(storage_kind: str, index: dict, z: torch.Tensor):
    """``(q_side, score)`` for one storage kind: the query side (fp32:
    bf16(z); onebit: z; int8: bf16(z⊙scale) and z·zero) and
    ``score(*q_side rows, block) → (Q_rows, B) f32``.

    The query side is prepared once for the whole batch, so every
    schedule — one pass over the KB, chunks of queries and doc blocks, any
    shard count — scores each (query, doc) pair with the same bits.
    """
    if storage_kind == "fp32":
        def score(zb, block):
            return zb @ block.to(torch.bfloat16).float().T
        return (z.to(torch.bfloat16).float(),), score
    if storage_kind == "onebit":
        def score(zc, block):
            return binary_ip_scores(zc, block, block.shape[-1] * 32,
                                    offset=0.5, use_kernel=True)
        return (z,), score
    if storage_kind == "int8":
        def score(qs, bias, block):
            return int8_ip(qs, block, bias=bias)
        return ((z * index["scale"]).to(torch.bfloat16),
                z @ index["zero"]), score
    raise ValueError(f"unknown storage {storage_kind!r}")


def kb_search_topk(index: dict, z: torch.Tensor, *, storage_kind: str,
                   topk_impl: str, k: int, n_shards: int = 1,
                   query_chunk: int = 512, doc_chunk: int = 131072):
    """The KB search step after the query encode: encoded queries ``z``
    (Q, d′) → top-k (values, int64 ids) by (score desc, id asc).

    ``naive`` scores the whole KB at once and ranks each row;
    ``two_stage`` streams doc blocks per query chunk (``repro``'s chunk
    and block counts), both in ``retrieval.topk``'s exact loop.  With
    ``n_shards`` > 1 each shard — rows split in order, row-major over the
    mesh's doc axes — streams its own rows, then its k candidates are
    gathered in shard order and merged.  Traffic a query: shards · k ·
    (4 + 8) bytes, independent of the KB's size.
    """
    q_side, score = make_kb_scorer(storage_kind, index, z)
    storage = index["storage"]
    n_q, n_rows = z.shape[0], storage.shape[0]
    if topk_impl == "naive":
        return _exact_topk(score, q_side, storage, k, kernel=True,
                           query_chunk=n_q, doc_chunk=n_rows)
    if n_rows % n_shards:
        raise ValueError(f"{n_rows} KB rows do not split into "
                         f"{n_shards} shards")
    n_loc = n_rows // n_shards
    chunks = dict(
        kernel=True,
        query_chunk=n_q // first_divisor_leq(n_q, cdiv(n_q, query_chunk)),
        doc_chunk=n_loc // first_divisor_leq(n_loc, cdiv(n_loc, doc_chunk)))
    parts = [_exact_topk(score, q_side, storage[s * n_loc:(s + 1) * n_loc],
                         k, **chunks) for s in range(n_shards)]
    if n_shards == 1:
        return parts[0]
    vals = torch.cat([v for v, _ in parts], dim=1)
    idx = torch.cat([i + s * n_loc for s, (_, i) in enumerate(parts)], dim=1)
    COUNTER.add("all-gather", vals, idx)
    return topk_in_order(vals, idx, k)


def _kb_search_bundle(arch, shape, rules, mesh, reduced) -> StepBundle:
    """The paper's production path: compressed (PCA-128 + int8, 24×) KB
    sharded over the mesh; fused query transform; distributed top-k.

    The step takes any row count that splits over the doc shards (the
    abstract storage is ``repro``'s: n_docs padded to the mesh size)."""
    cfg = arch.reduced if reduced else arch.model
    dims = B.shape_dims(shape, reduced)
    n_docs = dims["n_docs"]
    if mesh is not None:
        total = 1
        for v in mesh.shape.values():
            total *= v
        n_docs = (n_docs + total - 1) // total * total
    d, dc = cfg.dim, cfg.pca_dim
    storage_kind = getattr(cfg, "storage", "int8")

    def meta(shape_, dt=torch.float32):
        return torch.empty(shape_, dtype=dt, device="meta")

    storage = {"int8": meta((n_docs, dc), torch.uint8),
               "fp32": meta((n_docs, dc)),
               "onebit": meta((n_docs, dc // 32), torch.int32)}
    index_state = {"storage": storage[storage_kind],
                   "mu1": meta((d,)), "w": meta((d, dc)), "mu2": meta((dc,)),
                   "scale": meta((dc,)), "zero": meta((dc,))}
    batch = B.input_specs(arch, shape, reduced)
    index_specs = {
        "storage": spec_for_shape(tuple(index_state["storage"].shape),
                                  ("kb_docs", None), rules, mesh),
        "mu1": P(), "w": P(), "mu2": P(), "scale": P(), "zero": P(),
    }
    n_shards = 1
    for a in kb_doc_axes(rules, mesh):
        n_shards *= mesh.shape[a]
    rank = functools.partial(
        kb_search_topk, storage_kind=storage_kind,
        topk_impl=getattr(cfg, "topk_impl", "naive"), k=dims["k"],
        n_shards=n_shards, query_chunk=getattr(cfg, "query_chunk", 512),
        doc_chunk=getattr(cfg, "doc_chunk", 131072))

    def search(index, batch):
        return rank(index, encode_kb_queries(index, batch["queries"]))

    n_q = batch["queries"].shape[0]
    return StepBundle(
        name=f"{arch.name}:{shape.name}", fn=search,
        abstract_args=(index_state, batch),
        in_specs=(index_specs, _batch_specs(batch, rules, mesh, shape.kind)),
        model_flops_fn=lambda: 2 * n_q * (d * dc + n_docs * dc),
        counts_collectives=True)


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------


def build_step(arch: ArchConfig, shape: ShapeSpec, mesh,
               rules: Optional[AxisRules], reduced: bool = False,
               unroll: bool = False) -> StepBundle:
    if rules is None:
        rules = SINGLE_POD_RULES
    kind = shape.kind
    if kind == "lm_train":
        return _lm_train_bundle(arch, shape, rules, mesh, reduced, unroll)
    if kind == "lm_prefill":
        return _lm_prefill_bundle(arch, shape, rules, mesh, reduced, unroll)
    if kind == "lm_decode":
        return _lm_decode_bundle(arch, shape, rules, mesh, reduced, unroll)
    if kind.startswith("gnn"):
        return _gnn_bundle(arch, shape, rules, mesh, reduced)
    if kind.startswith("recsys") or kind == "retrieval_cand":
        return _recsys_bundle(arch, shape, rules, mesh, reduced)
    if kind == "kb_search":
        return _kb_search_bundle(arch, shape, rules, mesh, reduced)
    raise ValueError(f"unknown shape kind {kind!r}")
