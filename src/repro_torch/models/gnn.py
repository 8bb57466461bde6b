"""SchNet (Schütt et al., arXiv:1706.08566) in PyTorch.

Counterpart of ``repro.models.gnn``, over the same parameter trees.
Message passing is a gather over the edge sources and an ``index_add_``
over the edge destinations (``repro``'s ``segment_sum``):

    cfconv:  m_ij = (W₁ x_src(j))  ⊙  filter(rbf(‖r_i − r_j‖))
             x_i ← x_i + W₂ · ssp( segment_sum_i(m_ij) )

Supports the three input regimes of the assigned shapes: full graphs and
sampled minibatches (node features projected into the hidden space,
per-node classification) and batched small molecules (atom-type
embeddings, per-graph energy readout).  Activations run in bf16, as in
``repro``.  Node ids in ``edge_index`` must lie in ``[0, N)``; on the card
the segment sums are atomic, so they are not bit-reproducible there.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SchNetConfig
from repro_torch.models import layers as L
from repro_torch.models.recsys import embedding_lookup, segment_sum
from repro_torch.utils import DeviceLike

BF16 = torch.bfloat16
LOG2 = math.log(2.0)


def ssp(x: torch.Tensor) -> torch.Tensor:
    """Shifted softplus (SchNet's activation)."""
    return F.softplus(x) - LOG2


def rbf_expand(dist: torch.Tensor, n_rbf: int, cutoff: float
               ) -> torch.Tensor:
    """(E,) distances → (E, n_rbf) Gaussian radial basis.

    The centres are the f32 values ``repro``'s ``jnp.linspace`` gives on
    XLA (i · f32(cutoff/(n−1)), the last exactly ``cutoff``), not
    ``torch.linspace``'s: an ulp of a centre moves a basis value by ~1e-4
    relative at SchNet's γ ≈ 900.
    """
    f32 = dict(dtype=torch.float32, device=dist.device)
    delta = torch.tensor(cutoff, **f32) / torch.tensor(n_rbf - 1, **f32)
    centers = torch.cat([torch.arange(n_rbf - 1, **f32) * delta,
                         torch.tensor([cutoff], **f32)])
    gamma = 1.0 / (centers[1] - centers[0]) ** 2
    return torch.exp(-gamma * torch.square(dist[:, None] - centers[None, :]))


def interaction_spec(cfg: SchNetConfig) -> dict:
    h, r = cfg.d_hidden, cfg.n_rbf
    return {
        "w_pre": L.dense_spec(h, h, None, None, bias=False),
        "filter1": L.dense_spec(r, h, None, "ff"),
        "filter2": L.dense_spec(h, h, "ff", None),
        "w_post1": L.dense_spec(h, h, None, "ff"),
        "w_post2": L.dense_spec(h, h, "ff", None),
    }


def schnet_spec(cfg: SchNetConfig) -> dict:
    h = cfg.d_hidden
    spec = {
        "interactions": [interaction_spec(cfg)
                         for _ in range(cfg.n_interactions)],
        "readout1": L.dense_spec(h, max(h // 2, 8), None, "ff"),
    }
    if cfg.d_feat_in:
        spec["feat_proj"] = L.dense_spec(cfg.d_feat_in, h, None, None)
    else:
        spec["atom_embed"] = L.ParamSpec((cfg.n_atom_types, h),
                                         ("vocab", None), "embed", 1.0)
    out_dim = cfg.n_classes if cfg.task == "node" else 1
    spec["readout2"] = L.dense_spec(max(h // 2, 8), out_dim, "ff", None)
    return spec


def init(generator: Optional[torch.Generator], cfg: SchNetConfig,
         device: DeviceLike = None) -> dict:
    return L.init_params(generator, schnet_spec(cfg), device)


def _interaction(p: dict, x: torch.Tensor, edge_src: torch.Tensor,
                 edge_dst: torch.Tensor, rbf: torch.Tensor, edge_mask,
                 n_nodes: int) -> torch.Tensor:
    """One cfconv + atom-wise update block."""
    w = ssp(L.dense(p["filter1"], rbf.to(BF16)))
    w = L.dense(p["filter2"], w)                          # (E, h) filters
    if edge_mask is not None:
        w = w * edge_mask[:, None].to(BF16)
    m = L.dense(p["w_pre"], x)[edge_src] * w              # (E, h) messages
    agg = segment_sum(m, edge_dst, n_nodes)
    agg = ssp(L.dense(p["w_post1"], agg))
    agg = L.dense(p["w_post2"], agg)
    return x + agg


def _embed_and_pass(params: dict, batch: dict, cfg: SchNetConfig
                    ) -> torch.Tensor:
    """Node inputs → hidden states after every interaction block (bf16)."""
    pos = batch["positions"].float()
    edge_src, edge_dst = batch["edge_index"][0], batch["edge_index"][1]
    if "features" in batch:
        x = L.dense(params["feat_proj"], batch["features"].to(BF16))
    else:
        x = embedding_lookup(params["atom_embed"],
                             batch["atom_types"]).to(BF16)
    diff = pos[edge_src] - pos[edge_dst]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    rbf = rbf_expand(dist, cfg.n_rbf, cfg.cutoff)
    for p_int in params["interactions"]:
        x = _interaction(p_int, x, edge_src, edge_dst, rbf,
                         batch.get("edge_mask"), pos.shape[0])
    return x


def forward(params: dict, batch: dict, cfg: SchNetConfig,
            n_graphs: Optional[int] = None) -> torch.Tensor:
    """batch: positions (N,3), edge_index (2,E), and either
    ``features`` (N, d_feat) or ``atom_types`` (N,); optional edge_mask (E,),
    node_mask (N,), graph_ids (N,) for molecule batching.  ``n_graphs``
    defaults to the targets' batch dim for graph tasks.

    Returns per-node outputs (N, n_classes) for node tasks, or per-graph
    energies (G,) for graph tasks.
    """
    x = _embed_and_pass(params, batch, cfg)
    h = ssp(L.dense(params["readout1"], x))
    out = L.dense(params["readout2"], h).float()
    if cfg.task == "graph":
        if n_graphs is None:
            n_graphs = int(batch["targets"].shape[0])
        e = out[:, 0]
        node_mask = batch.get("node_mask")
        if node_mask is not None:
            e = e * node_mask
        return segment_sum(e, batch["graph_ids"], n_graphs)
    return out


def node_embeddings(params: dict, batch: dict, cfg: SchNetConfig
                    ) -> torch.Tensor:
    """Hidden-state embeddings (N, d_hidden) — the KB index for the paper's
    compression technique (molecule/node retrieval)."""
    return _embed_and_pass(params, batch, cfg).float()


def loss_fn(params: dict, batch: dict, cfg: SchNetConfig):
    out = forward(params, batch, cfg)
    if cfg.task == "graph":
        loss = torch.mean(torch.square(out - batch["targets"]))
        return loss, {"mse": loss}
    logp = torch.log_softmax(out, dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"].long()[:, None])[:, 0]
    mask = batch.get("label_mask")
    if mask is not None:
        loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    else:
        loss = torch.mean(nll)
    return loss, {"ce": loss}
