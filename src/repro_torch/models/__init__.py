"""Model zoo in PyTorch: SchNet GNN and the recsys architectures
(two-tower, FM, DIN, DCN-v2); the transformer LMs are still to port.

Counterpart of ``repro.models``.  Models are plain functions over
parameter dicts built on the ParamSpec DSL in
:mod:`repro_torch.models.layers` — one source of truth for shapes, init
and logical sharding axes — with gradients by autograd.
"""
