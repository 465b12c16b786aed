from repro_torch.kernels.linear_scan.ops import linear_scan  # noqa: F401
