from repro_torch.kernels.ivf_fused import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]
