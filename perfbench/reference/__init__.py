"""Plain PyTorch references of what the benchmark's configurations run.

``emulator``: an analog projection as the paper defines it: the weight
mapped onto differential 1T1R crossbars (case-A blocks of 4 tiles x 64
wordlines x 2 bitlines), each (row, block) pair of both voltage rails
through the Conv4Xbar network of Fig. 3 / Table 2, block groups summed
digitally.  ``decoder``: the decoder families' forward (prefill and one
decode step through a KV cache), the analog projections through
``emulator``.

These modules import nothing of ``repro_torch``, ``repro`` or ``jax``:
they take the weights, the emulator's parameters and the inputs the
benchmark made, and work out everything the program derives from them
(conductances, drives, caches) again.  Their numerics are the
configuration's: bf16 parameters and activations where the
configuration serves in bf16, the emulator in float32 with TF32 off
(``tf32=True`` is the control, the nearest precision below).
"""
