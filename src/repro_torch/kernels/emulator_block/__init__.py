# The B2 dispatcher is ``ops.emulator_block``: the package attribute of that
# name stays the kernel module ``emulator_block.py``.
from repro_torch.kernels.emulator_block.ops import (  # noqa: F401
    emulator_block_grid, emulator_block_unified)
