from repro_torch.kernels.grouped_matmul.ops import grouped_matmul  # noqa: F401
