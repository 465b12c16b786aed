"""Per-layer wiring: norms + residuals + attention + FFN (port of
``repro.models.blocks`` for the attention layers gemma3 uses)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ATTN_KINDS
from repro_torch.models.attention import (attention_schema, attn_mixer,
                                          attn_cache_schema)
from repro_torch.models.common import (activation, apply_norm, dense,
                                       dense_schema, norm_schema)


def mlp_schema(cfg: ArchConfig):
    d, f = cfg.d_model, cfg.d_ff
    s = {"w_up": dense_schema(d, f), "w_down": dense_schema(f, d)}
    if cfg.mlp_gated:
        s["w_gate"] = dense_schema(d, f)
    return s


def mlp_apply(params, x, cfg: ArchConfig, pcfg=None):
    act = activation(cfg.mlp_act)
    up = dense(x, params["w_up"], "mlp.up")
    if cfg.mlp_gated:
        g = dense(x, params["w_gate"], "mlp.gate")
        h = act(g) * up
    else:
        h = act(up)
    return dense(h, params["w_down"], "mlp.down")


def _check_kind(cfg: ArchConfig, kind: str):
    if kind not in ATTN_KINDS or cfg.parallel_block or cfg.encoder_layers \
            or cfg.norm != "rmsnorm" or cfg.qkv_bias:
        raise NotImplementedError(
            f"layer kind {kind!r} of {cfg.name} is not ported yet "
            "(ROADMAP A9: the other families)")


def layer_schema(cfg: ArchConfig, kind: str):
    _check_kind(cfg, kind)
    d = cfg.d_model
    s: Dict[str, Any] = {"norm1": norm_schema(d, cfg.norm),
                         "attn": attention_schema(cfg),
                         "norm2": norm_schema(d, cfg.norm),
                         "ff": mlp_schema(cfg)}
    if cfg.post_norms:
        s["post_norm1"] = norm_schema(d, cfg.norm)
        s["post_norm2"] = norm_schema(d, cfg.norm)
    return s


def layer_cache_schema(cfg: ArchConfig, kind: str, batch: int, s_max: int,
                       dtype=None):
    """{name: {"k"/"v": (shape, dtype)}} for one layer's decode cache."""
    return {"attn": attn_cache_schema(cfg, kind, batch, s_max,
                                      dtype=dtype or torch.bfloat16)}


def apply_layer(params, x, *, cfg: ArchConfig, pcfg, kind: str,
                mode: str = "train", cache=None, pos=None, positions=None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (x, new_cache_or_None)."""
    h = apply_norm(params["norm1"], x, cfg.norm)
    mix, mc = attn_mixer(params["attn"], h, cfg=cfg, pcfg=pcfg, kind=kind,
                         positions=positions,
                         cache=(cache or {}).get("attn"), pos=pos, mode=mode)
    if cfg.post_norms:
        mix = apply_norm(params["post_norm1"], mix, cfg.norm)
    x = x + mix
    h2 = apply_norm(params["norm2"], x, cfg.norm)
    ff = mlp_apply(params["ff"], h2, cfg, pcfg)
    if cfg.post_norms:
        ff = apply_norm(params["post_norm2"], ff, cfg.norm)
    x = x + ff
    return x, ({"attn": mc} if mc is not None else None)
