from repro_torch.kernels.embedding_bag.ops import embedding_bag  # noqa: F401
