"""Per-(arch × shape) batch synthesis + abstract input specs, in PyTorch.

Counterpart of ``repro.data.batches``.  Two consumers:
- sizing a step without allocating it wants ``input_specs(arch, shape)``
  — meta tensors only (full production dims);
- tests, the examples and training want ``make_batch(rng, arch, shape,
  reduced=True)`` — real arrays from the same code path, so shapes can't
  drift.

``make_batch`` draws with numpy's ``default_rng`` exactly as ``repro``
does, so both packages get byte-identical batches for every arch × shape;
the arrays become tensors on ``device`` at the end.

Node/edge counts are padded to multiples of 512 (production padding — keeps
every array shardable over a mesh).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import (ArchConfig, DCNConfig, DINConfig,
                                      FMConfig, LMConfig, SchNetConfig,
                                      ShapeSpec, TwoTowerConfig)
from repro_torch.utils import DeviceLike, resolve_device, round_up

I32 = torch.int32
F32 = torch.float32


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


# ---------------------------------------------------------------------------
# reduced (smoke) shape dims
# ---------------------------------------------------------------------------

def reduce_dims(shape: ShapeSpec) -> dict[str, int]:
    """Tiny version of each shape for CPU smoke tests."""
    k = shape.kind
    if k == "lm_train":
        return {"seq_len": 32, "global_batch": 4}
    if k == "lm_prefill":
        return {"seq_len": 64, "global_batch": 2}
    if k == "lm_decode":
        return {"seq_len": 64, "global_batch": 2}
    if k == "gnn_full":
        return {"n_nodes": 512, "n_edges": 2048,
                "d_feat": shape.dims.get("d_feat", 64)}
    if k == "gnn_mini":
        return {"n_nodes": 512, "n_edges": 2048, "batch_nodes": 32,
                "fanout1": 3, "fanout2": 2}
    if k == "gnn_molecule":
        return {"n_nodes": 12, "n_edges": 24, "batch": 4}
    if k == "recsys_train":
        return {"batch": 64}
    if k == "recsys_serve":
        return {"batch": 32}
    if k == "retrieval_cand":
        return {"batch": 2, "n_candidates": 512}
    if k == "kb_search":
        return {"n_docs": 4096, "n_queries": 64, "k": 8}
    raise ValueError(k)


def shape_dims(shape: ShapeSpec, reduced: bool) -> dict[str, int]:
    return reduce_dims(shape) if reduced else dict(shape.dims)


# ---------------------------------------------------------------------------
# abstract specs per shape kind
# ---------------------------------------------------------------------------


def input_specs(arch: ArchConfig, shape: ShapeSpec,
                reduced: bool = False) -> dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every step input (batch part only)."""
    dims = shape_dims(shape, reduced)
    model = arch.reduced if reduced else arch.model
    kind = shape.kind

    if kind in ("lm_train", "lm_prefill"):
        b, s = dims["global_batch"], dims["seq_len"]
        spec = {"tokens": _struct((b, s), I32)}
        if kind == "lm_train":
            spec["labels"] = _struct((b, s), I32)
        return spec

    if kind == "lm_decode":
        b = dims["global_batch"]
        return {"tokens": _struct((b,), I32)}

    if kind == "gnn_full":
        n = round_up(dims["n_nodes"], 512)
        e = round_up(dims["n_edges"], 512)
        return {
            "features": _struct((n, dims["d_feat"]), F32),
            "positions": _struct((n, 3), F32),
            "edge_index": _struct((2, e), I32),
            "edge_mask": _struct((e,), F32),
            "labels": _struct((n,), I32),
            "label_mask": _struct((n,), F32),
        }

    if kind == "gnn_mini":
        bn = dims["batch_nodes"]
        f1, f2 = dims["fanout1"], dims["fanout2"]
        n_sub = round_up(bn * (1 + f1 + f1 * f2), 512)
        e_sub = round_up(bn * (f1 + f1 * f2), 512)
        return {
            "features": _struct((n_sub, 602), F32),   # reddit-like d_feat
            "positions": _struct((n_sub, 3), F32),
            "edge_index": _struct((2, e_sub), I32),
            "edge_mask": _struct((e_sub,), F32),
            "labels": _struct((n_sub,), I32),
            "label_mask": _struct((n_sub,), F32),     # 1 on seed nodes
        }

    if kind == "gnn_molecule":
        b, na, ne = dims["batch"], dims["n_nodes"], dims["n_edges"]
        n, e = b * na, b * ne
        return {
            "atom_types": _struct((n,), I32),
            "positions": _struct((n, 3), F32),
            "edge_index": _struct((2, e), I32),
            "edge_mask": _struct((e,), F32),
            "graph_ids": _struct((n,), I32),
            "targets": _struct((b,), F32),
        }

    if kind in ("recsys_train", "recsys_serve"):
        b = dims["batch"]
        if isinstance(model, TwoTowerConfig):
            return {"user_ids": _struct((b, model.n_user_features), I32),
                    "item_ids": _struct((b, model.n_item_features), I32)}
        if isinstance(model, FMConfig):
            spec = {"sparse_ids": _struct((b, model.n_sparse), I32)}
        elif isinstance(model, DINConfig):
            spec = {"target_ids": _struct((b,), I32),
                    "history_ids": _struct((b, model.seq_len), I32),
                    "history_mask": _struct((b, model.seq_len), F32),
                    "context_ids": _struct((b, model.n_context_features),
                                           I32)}
        elif isinstance(model, DCNConfig):
            spec = {"dense": _struct((b, model.n_dense), F32),
                    "sparse_ids": _struct((b, model.n_sparse), I32)}
        else:
            raise TypeError(type(model))
        if kind == "recsys_train":
            spec["labels"] = _struct((b,), F32)
        return spec

    if kind == "retrieval_cand":
        b, n_cand = dims["batch"], dims["n_candidates"]
        if isinstance(model, TwoTowerConfig):
            return {"user_ids": _struct((b, model.n_user_features), I32),
                    "cand_ids": _struct((n_cand, model.n_item_features),
                                        I32)}
        if isinstance(model, FMConfig):
            return {"context_ids": _struct((1, model.n_sparse - 1), I32),
                    "cand_ids": _struct((n_cand,), I32)}
        if isinstance(model, DINConfig):
            return {"history_ids": _struct((1, model.seq_len), I32),
                    "context_ids": _struct((1, model.n_context_features),
                                           I32),
                    "cand_ids": _struct((n_cand,), I32)}
        if isinstance(model, DCNConfig):
            return {"dense": _struct((1, model.n_dense), F32),
                    "sparse_ids": _struct((1, model.n_sparse - 1), I32),
                    "cand_ids": _struct((n_cand,), I32)}
        raise TypeError(type(model))

    if kind == "kb_search":
        return {"queries": _struct((dims["n_queries"], model.dim), F32)}

    raise ValueError(f"unknown shape kind {kind!r}")


# ---------------------------------------------------------------------------
# concrete batches (smoke tests, examples, training)
# ---------------------------------------------------------------------------


def make_batch(rng: np.random.Generator, arch: ArchConfig, shape: ShapeSpec,
               reduced: bool = True, device: DeviceLike = None
               ) -> dict[str, torch.Tensor]:
    """Materialize a batch matching input_specs (deterministic in rng)."""
    dev = resolve_device(device)
    specs = input_specs(arch, shape, reduced=reduced)
    model = arch.reduced if reduced else arch.model
    out: dict[str, np.ndarray] = {}
    for name, s in specs.items():
        if s.dtype == I32:
            hi = _vocab_limit(name, model, s)
            arr = rng.integers(0, hi, size=s.shape, dtype=np.int32)
        else:
            arr = rng.standard_normal(s.shape).astype(np.float32)
            if name.endswith("mask"):
                arr = np.ones(s.shape, np.float32)
            if name == "labels" and s.dtype == F32:
                arr = rng.integers(0, 2, size=s.shape).astype(np.float32)
        out[name] = arr

    # fix up semantic constraints
    if "edge_index" in out:
        n_nodes = int(specs["positions"].shape[0])
        e = specs["edge_index"].shape[1]
        out["edge_index"] = rng.integers(0, n_nodes, size=(2, e),
                                         dtype=np.int32)
    if "graph_ids" in out:
        dims = shape_dims(shape, reduced)
        out["graph_ids"] = np.repeat(np.arange(dims["batch"], dtype=np.int32),
                                     dims["n_nodes"])
    if "labels" in out and specs["labels"].dtype == I32:
        n_cls = getattr(model, "n_classes", None) or 16
        out["labels"] = out["labels"] % np.int32(n_cls)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in out.items()}
    if shape.kind == "lm_train":
        batch["labels"] = batch["tokens"]  # next-token proxy on synthetic data
    return batch


def _vocab_limit(name: str, model: Any, s) -> int:
    if isinstance(model, LMConfig):
        return model.vocab_size
    if isinstance(model, SchNetConfig):
        if name == "atom_types":
            return model.n_atom_types
        if name == "labels":
            return model.n_classes
        if name == "edge_index":
            return max(2, s.shape[-1] // 4)   # overwritten below by caller
        return 2 ** 30
    if isinstance(model, TwoTowerConfig):
        if name == "user_ids":
            return model.user_vocab
        return model.item_vocab
    if isinstance(model, FMConfig):
        return model.vocab_per_field
    if isinstance(model, DINConfig):
        if name == "context_ids":
            return model.context_vocab
        return model.item_vocab
    if isinstance(model, DCNConfig):
        return model.vocab_per_field
    return 2 ** 30


def fix_edges(batch: dict, n_nodes: int,
              rng: np.random.Generator) -> dict:
    """Resample edge_index within [0, n_nodes) (callers with real graphs
    supply their own edges; synthetic ones need valid node ids)."""
    e = batch["edge_index"].shape[1]
    batch = dict(batch)
    batch["edge_index"] = torch.from_numpy(
        rng.integers(0, n_nodes, size=(2, e), dtype=np.int32)).to(
            batch["edge_index"].device)
    return batch
