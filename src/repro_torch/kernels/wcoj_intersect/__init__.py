from repro_torch.kernels.wcoj_intersect.ops import wcoj_intersect  # noqa: F401
