from repro_torch.parallel.collectives import (  # noqa: F401
    compressed_all_reduce, compressed_grad_sync, int8_compress,
    int8_decompress)
