from repro_torch.kernels.binary_ip import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]
