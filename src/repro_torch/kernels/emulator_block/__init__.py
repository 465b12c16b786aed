from repro_torch.kernels.emulator_block.ops import emulator_block_unified  # noqa: F401
