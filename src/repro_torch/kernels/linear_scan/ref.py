"""Plain-PyTorch oracle for the diagonal gated linear recurrence
``h_t = a_t * h_{t-1} + b_t`` along axis 1 (port of the JAX package's
``kernels/linear_scan/ref.py``, the primitive behind Mamba-1 and
RG-LRU).  The reference combines the steps with an associative scan;
this copy runs the same recurrence as a log-depth (Hillis-Steele) scan
over the sequence, which sums in another order."""
import torch


def linear_scan_ref(a, b, h0=None):
    """a, b: (B, S, D); h0: (B, D) or None -> (h (B,S,D), h_last (B,D))."""
    if h0 is not None:
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * h0
    aa, bb = a, b
    step = 1
    while step < a.shape[1]:
        # combine (a1, b1) then (a2, b2): (a2*a1, a2*b1 + b2)
        prev_a = torch.ones_like(aa)
        prev_b = torch.zeros_like(bb)
        prev_a[:, step:] = aa[:, :-step]
        prev_b[:, step:] = bb[:, :-step]
        aa, bb = aa * prev_a, aa * prev_b + bb
        step *= 2
    return bb, bb[:, -1]
