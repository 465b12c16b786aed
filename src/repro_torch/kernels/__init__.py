"""Kernels written by hand for Hopper, each beside its plain PyTorch
version (ROADMAP Queue B).  One package per kernel family of the JAX
package, each with an ``ops`` entry point of the reference's name:

* ``emulator_block`` -- the Conv4Xbar block evaluators B1
  (``emulator_block_unified``, f32 and bf16 modes), B2
  (``emulator_block``) and B3 (``emulator_block_grid``);
* ``xbar_mac`` -- the nonlinear crossbar MAC B4 (``xbar_mac``);
* ``flash_attention`` -- online-softmax attention B5
  (``flash_attention``);
* ``linear_scan`` -- the diagonal gated linear recurrence B6
  (``linear_scan``).

Every CUDA C++ source is built by ``_build`` (one ``nvcc`` per source, at
first use); importing a package compiles nothing.
"""
