from repro_torch.kernels.topk_blocks import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]
