from repro_torch.kernels.fused_quantize import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]
