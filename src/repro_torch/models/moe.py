"""Mixture-of-Experts FFN with capacity-based scatter dispatch (port of
``repro.models.moe``).  On a training mesh the mixer routes over the
whole batch's tokens (``moe_mixer``); its experts run replicated over
the model axis.

Dispatch is the GShard/Switch capacity scheme as a scatter/gather:
  pos_in_expert = cumsum(onehot(assign)) - 1     (token-major, then k)
  keep          = pos < capacity
  buffer[e, pos] += x_t                          (scatter-add, unique slots)
  y_t            = sum_k gate_k * buffer[e_k, pos_k]
The router runs in float32; the expert products are batched matmuls in
the buffer's dtype.  Neither the experts nor llama4's shared expert
reach ``dense()``: they stay digital under an analog executor, as in the
reference.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.common import (P, ParamSchema, activation,
                                       current_mesh, dense_schema)


def moe_schema(cfg: ArchConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    s = {
        "router": ParamSchema((d, e), "normal", d ** -0.5,
                              spec=P(None, None)),
        "w_up": ParamSchema((e, d, f), "normal", d ** -0.5,
                            spec=P("model", "data", None)),
        "w_down": ParamSchema((e, f, d), "normal", f ** -0.5,
                              spec=P("model", None, "data")),
    }
    if cfg.mlp_gated:
        s["w_gate"] = ParamSchema((e, d, f), "normal", d ** -0.5,
                                  spec=P("model", "data", None))
    if cfg.moe.shared_expert:
        s["shared_up"] = dense_schema(d, f)
        s["shared_down"] = dense_schema(f, d, fsdp="model", tp="data")
        if cfg.mlp_gated:
            s["shared_gate"] = dense_schema(d, f)
    return s


def _capacity(n_tokens: int, mcfg: MoEConfig, train: bool) -> int:
    """Slots per expert: ``n_tokens * top_k * factor / num_experts``
    rounded up to a multiple of 4, at least 4 (the training factor when
    ``train``, else the evaluation factor)."""
    cf = mcfg.capacity_factor if train else mcfg.eval_capacity_factor
    c = int(n_tokens * mcfg.top_k * cf / mcfg.num_experts)
    return max(4, -(-c // 4) * 4)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params, xt: torch.Tensor, mcfg: MoEConfig):
    """The router on (T, D) tokens: ``(probs (T, E) float32, gates (T, K),
    experts (T, K))``; for K > 1 the gates are renormalized over the
    token's K experts (with a 1e-9 floor)."""
    logits = xt.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, mcfg.top_k)
    if mcfg.top_k > 1:
        gate_vals = gate_vals / torch.clamp_min(
            gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_idx


def slots(expert_idx: torch.Tensor, E: int, C: int):
    """Each assignment's slot in the (E*C, D) buffer and whether it was
    kept: its rank within its expert in the global (t, k) order; an
    assignment past the capacity is dropped and points at slot
    ``E*C - 1``, with its input zeroed.  Returns (slot (T*K,), keep
    (T, K) bool)."""
    T, K = expert_idx.shape
    assign_oh = F.one_hot(expert_idx, E)                      # (T, K, E)
    flat_oh = assign_oh.reshape(T * K, E)
    pos = torch.cumsum(flat_oh, dim=0) - flat_oh              # exclusive rank
    pos = (pos.reshape(T, K, E) * assign_oh).sum(-1)          # (T, K)
    keep = pos < C
    slot = torch.where(keep, expert_idx * C + pos,
                       torch.full_like(pos, E * C - 1))
    return slot.reshape(T * K), keep


def moe_mixer(params, x: torch.Tensor, *, cfg: ArchConfig, pcfg=None,
              train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D).  Returns (y (B, S, D), the Switch load-balancing aux
    loss, a float32 scalar).  The capacity counts the whole call's
    tokens (T = B*S), so a token's output depends on its batch-mates.

    On a training mesh with a data axis, ``x`` is this rank's rows: the
    mixer routes over every data rank's tokens (``gather_rows``), so the
    capacity, the drops in the global (t, k) order and the aux loss are
    the unsharded step's, and returns this rank's rows of y."""
    mesh = current_mesh()
    if mesh is not None:
        from repro_torch.parallel.train_mesh import (data_size, gather_rows,
                                                     local_rows)
        if data_size(mesh) > 1:
            y, aux = _moe(params, gather_rows(x, mesh), cfg, train)
            return local_rows(y, mesh), aux
    return _moe(params, x, cfg, train)


def _moe(params, x: torch.Tensor, cfg: ArchConfig, train: bool):
    mcfg = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = mcfg.num_experts, mcfg.top_k
    C = _capacity(T, mcfg, train)
    act = activation(cfg.mlp_act)

    xt = x.reshape(T, D)
    probs, gate_vals, expert_idx = route(params, xt, mcfg)
    slot, keep = slots(expert_idx, E, C)
    xk = xt[:, None].expand(T, K, D).reshape(T * K, D)
    xk = xk * keep.reshape(-1, 1).to(xt.dtype)
    buf = xt.new_zeros((E * C, D)).index_add(0, slot, xk).reshape(E, C, D)

    up = torch.bmm(buf, params["w_up"].to(buf.dtype))
    if cfg.mlp_gated:
        g = torch.bmm(buf, params["w_gate"].to(buf.dtype))
        h = act(g) * up
    else:
        h = act(up)
    yb = torch.bmm(h, params["w_down"].to(h.dtype))

    yk = yb.reshape(E * C, D)[slot].reshape(T, K, D)
    y = (yk * (gate_vals * keep).to(yk.dtype)[..., None]).sum(dim=1)

    if mcfg.shared_expert:
        up_s = xt @ params["shared_up"].to(xt.dtype)
        if cfg.mlp_gated:
            h_s = act(xt @ params["shared_gate"].to(xt.dtype)) * up_s
        else:
            h_s = act(up_s)
        y = y + h_s @ params["shared_down"].to(h_s.dtype)

    # Switch-style load-balance aux loss
    top1 = F.one_hot(expert_idx[:, 0], E).float()
    aux = E * torch.sum(top1.mean(dim=0) * probs.mean(dim=0)) \
        * mcfg.router_aux_coef
    return y.reshape(B, S, D), aux
