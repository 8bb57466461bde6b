"""Model zoo in PyTorch: the transformer LMs (dense and MoE: ``attention``,
``moe``, ``transformer``), SchNet GNN and the recsys architectures
(two-tower, FM, DIN, DCN-v2).

Counterpart of ``repro.models``.  Models are plain functions over
parameter dicts built on the ParamSpec DSL in
:mod:`repro_torch.models.layers` — one source of truth for shapes, init
and logical sharding axes — with gradients by autograd.
"""

__all__ = ["attention", "gnn", "layers", "moe", "recsys", "transformer"]
