"""Parallelism (port of ``repro.parallel``): the tensor-parallel
partitioning of the analog serving plane (``sharding``, the reference's
``parallel/sharding.py``) and the int8-compressed gradient collectives
(``collectives``).  The reference's ``shard_map_compat`` shim has no
counterpart: a rank is a process of a ``torch.distributed`` group, and
its collectives are called directly."""
from repro_torch.parallel.collectives import (  # noqa: F401
    compressed_all_reduce, compressed_grad_sync, int8_compress,
    int8_decompress)
