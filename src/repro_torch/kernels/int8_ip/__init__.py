from repro_torch.kernels.int8_ip import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]
