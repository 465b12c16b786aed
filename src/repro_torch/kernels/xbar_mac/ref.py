"""Plain-PyTorch oracle for the nonlinear crossbar MAC (port of the JAX
package's ``kernels/xbar_mac/ref.py``).

Analog MAC with the analytic 1T1R cell model (threshold + curvature) and a
saturating integrator:

    i_cell = g * max(v - v_th, 0) * (1 + beta * v)
    out    = v_sat * tanh(gain * sum_k i_cell / v_sat)

The drive is computed in v's dtype, as the reference oracle does; the
kernel's plain version (``xbar_mac.xbar_mac_plain``) widens v first.
"""
import torch


def xbar_mac_ref(v, g, *, v_th=0.08, beta=0.6, gain=3200.0, v_sat=1.0):
    """v: (B, K) wordline voltages; g: (K, N) conductances -> (B, N) f32."""
    drive = torch.clamp_min(v - v_th, 0.0) * (1.0 + beta * v)   # (B, K)
    i = drive.float() @ g.float()                               # (B, N)
    return v_sat * torch.tanh(gain * i / v_sat)
