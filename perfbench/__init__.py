"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see
``perfbench/README.md``.  Nothing in this package imports ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro``; ``perfbench.reference``
imports nothing of ``repro_torch`` either.
"""
