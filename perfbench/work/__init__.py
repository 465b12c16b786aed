"""The yardstick's work counts: what a step has to compute, taken from
the traffic (the rows the requests really prefilled or decoded) and the
configuration's shapes, never from the program.

``peaks`` holds the card's published rates; ``b1`` the emulator-block
evaluator's operations and bytes (a frozen copy of the count the port's
kernels were designed against); ``digital`` the digital model's
operations per token.  A roofline share or an ``mfu`` is one of these
counts over a measured device time, so it reads the same whatever
implements the kernel.
"""
