from repro_torch.kernels.xbar_mac.ops import xbar_mac  # noqa: F401
