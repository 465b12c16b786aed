"""setup_s: process start to the first timed request (kernels built or
loaded, weights made, the executor's plans and states built, shapes
warmed), on the host's clock."""


def read(rec):
    return rec.setup_s
