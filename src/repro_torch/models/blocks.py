"""Per-layer wiring: norms + residuals + mixer + FFN (port of
``repro.models.blocks`` for the decoder's attention, RG-LRU and Mamba
layers).

A layer = (norm -> mixer -> residual) [+ (norm -> FFN/MoE -> residual)].
Mamba layers are mixer-only (the mixer subsumes the FFN); cohere-style
``parallel_block`` computes attention and FFN from the same normed
input."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig, ATTN_KINDS, MAMBA, RECURRENT
from repro_torch.models.attention import (attention_schema, attn_mixer,
                                          attn_cache_schema)
from repro_torch.models.common import (activation, apply_norm, dense,
                                       dense_schema, norm_schema)
from repro_torch.models.moe import moe_mixer, moe_schema
from repro_torch.models.ssm import (mamba_cache_schema, mamba_mixer,
                                    mamba_schema, rglru_cache_schema,
                                    rglru_mixer, rglru_schema)


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
    if kind not in ATTN_KINDS + (RECURRENT, MAMBA) or cfg.encoder_layers:
        raise NotImplementedError(
            f"layer kind {kind!r} of {cfg.name} is not ported yet "
            "(ROADMAP A9c: the encoder)")


def layer_schema(cfg: ArchConfig, kind: str):
    _check_kind(cfg, kind)
    d = cfg.d_model
    s: Dict[str, Any] = {"norm1": norm_schema(d, cfg.norm)}
    if kind == RECURRENT:
        s["mixer"] = rglru_schema(cfg)
    elif kind == MAMBA:
        s["mixer"] = mamba_schema(cfg)
    else:
        s["attn"] = attention_schema(cfg)
    if kind != MAMBA and not cfg.parallel_block:
        s["norm2"] = norm_schema(d, cfg.norm)
    if kind != MAMBA:
        s["ff"] = moe_schema(cfg) if cfg.moe is not None else mlp_schema(cfg)
    if cfg.post_norms:
        s["post_norm1"] = norm_schema(d, cfg.norm)
        if kind != MAMBA:
            s["post_norm2"] = norm_schema(d, cfg.norm)
    return s


def layer_cache_schema(cfg: ArchConfig, kind: str, batch: int, s_max: int,
                       dtype=None):
    """{name: {leaf: (shape, dtype)}} for one layer's decode cache: an
    attention layer's "k"/"v" under "attn", a recurrent layer's "conv"
    (in ``dtype``) and "h" (float32) under "mixer"."""
    dt = dtype or torch.bfloat16
    if kind == RECURRENT:
        return {"mixer": rglru_cache_schema(cfg, batch, dtype=dt)}
    if kind == MAMBA:
        return {"mixer": mamba_cache_schema(cfg, batch, dtype=dt)}
    return {"attn": attn_cache_schema(cfg, kind, batch, s_max, dtype=dt)}


def _ffn(params, h, cfg: ArchConfig, pcfg, mode: str):
    """The layer's FFN on normed ``h``: (out, aux loss); an MLP's aux is
    the number 0.0 (no device work)."""
    if cfg.moe is not None:
        return moe_mixer(params, h, cfg=cfg, pcfg=pcfg,
                         train=(mode == "train"))
    return mlp_apply(params, h, cfg, pcfg), 0.0


def apply_layer(params, x, *, cfg: ArchConfig, pcfg, kind: str,
                mode: str = "train", cache=None, pos=None, positions=None
                ) -> Tuple[torch.Tensor, Optional[dict], Union[torch.Tensor, float]]:
    """Returns (x, new_cache_or_None, aux loss): an MoE FFN's
    load-balancing loss (a float32 scalar), else the number 0.0."""
    aux = 0.0
    c = cache or {}
    h = apply_norm(params["norm1"], x, cfg.norm)
    if kind == RECURRENT:
        mix, mc = rglru_mixer(params["mixer"], h, cfg=cfg, pcfg=pcfg,
                              cache=c.get("mixer"), mode=mode)
    elif kind == MAMBA:
        mix, mc = mamba_mixer(params["mixer"], h, cfg=cfg, pcfg=pcfg,
                              cache=c.get("mixer"), mode=mode)
    else:
        mix, mc = attn_mixer(params["attn"], h, cfg=cfg, pcfg=pcfg,
                             kind=kind, positions=positions,
                             cache=c.get("attn"), pos=pos, mode=mode)
    new_cache = (None if mc is None else
                 {"attn" if kind in ATTN_KINDS else "mixer": mc})
    if cfg.post_norms:
        mix = apply_norm(params["post_norm1"], mix, cfg.norm)
    if cfg.parallel_block and kind in ATTN_KINDS:
        # x + attn(n(x)) + ff(n(x))  (cohere)
        ff, aux = _ffn(params["ff"], h, cfg, pcfg, mode)
        return x + mix + ff, new_cache, aux
    x = x + mix
    if kind != MAMBA:
        h2 = apply_norm(params["norm2"], x, cfg.norm)
        ff, aux = _ffn(params["ff"], h2, cfg, pcfg, mode)
        if cfg.post_norms:
            ff = apply_norm(params["post_norm2"], ff, cfg.norm)
        x = x + ff
    return x, new_cache, aux
