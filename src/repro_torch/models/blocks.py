"""Per-layer wiring: norms + residuals + mixer + FFN (port of
``repro.models.blocks`` for every layer kind).

A layer = (norm -> mixer -> residual) [+ (norm -> cross attention ->
residual)] [+ (norm -> FFN/MoE -> residual)].  Mamba layers are
mixer-only (the mixer subsumes the FFN); cohere-style ``parallel_block``
computes attention and FFN from the same normed input; an
encoder-decoder's decoder layers attend to the encoder's output between
the two."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig, ATTN_KINDS, MAMBA, RECURRENT
from repro_torch.models.attention import (_project_kv, attention_schema,
                                          attn_cache_schema, attn_mixer)
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


def layer_schema(cfg: ArchConfig, kind: str, *, cross: bool = False):
    """``cross``: the layer also attends to the encoder's output
    (``norm_cross``, ``cross``)."""
    d = cfg.d_model
    s: Dict[str, Any] = {"norm1": norm_schema(d, cfg.norm)}
    if kind in ATTN_KINDS:
        s["attn"] = attention_schema(cfg)
    elif kind == RECURRENT:
        s["mixer"] = rglru_schema(cfg)
    elif kind == MAMBA:
        s["mixer"] = mamba_schema(cfg)
    else:
        raise ValueError(kind)
    if cross:
        s["norm_cross"] = norm_schema(d, cfg.norm)
        s["cross"] = attention_schema(cfg, cross=True)
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
                       *, cross_len: int = 0, dtype=None):
    """{name: {leaf: (shape, dtype)}} for one layer's decode cache: an
    attention layer's "k"/"v" under "attn", a recurrent layer's "conv"
    (in ``dtype``) and "h" (float32) under "mixer"; with ``cross_len``
    the encoder's projected "k"/"v" (B, cross_len, Hkv, Dh) under
    "cross"."""
    dt = dtype or torch.bfloat16
    if kind == RECURRENT:
        out = {"mixer": rglru_cache_schema(cfg, batch, dtype=dt)}
    elif kind == MAMBA:
        out = {"mixer": mamba_cache_schema(cfg, batch, dtype=dt)}
    else:
        out = {"attn": attn_cache_schema(cfg, kind, batch, s_max, dtype=dt)}
    if cross_len:
        shape = (batch, cross_len, cfg.num_kv_heads, cfg.head_dim)
        out["cross"] = {"k": (shape, dt), "v": (shape, dt)}
    return out


def _ffn(params, h, cfg: ArchConfig, pcfg, mode: str):
    """The layer's FFN on normed ``h``: (out, aux loss); an MLP's aux is
    the number 0.0 (no device work)."""
    if cfg.moe is not None:
        return moe_mixer(params, h, cfg=cfg, pcfg=pcfg,
                         train=(mode == "train"))
    return mlp_apply(params, h, cfg, pcfg), 0.0


def apply_layer(params, x, *, cfg: ArchConfig, pcfg, kind: str,
                mode: str = "train", cache=None, pos=None, positions=None,
                enc_out=None
                ) -> Tuple[torch.Tensor, Optional[dict], Union[torch.Tensor, float]]:
    """Returns (x, new_cache_or_None, aux loss): an MoE FFN's
    load-balancing loss (a float32 scalar), else the number 0.0.  A
    layer with a ``cross`` block attends to ``enc_out`` (B, S_enc, D) at
    train and prefill, prefill keeping its projected keys and values as
    the "cross" cache; decode reads that cache and returns it as it is."""
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
    new_cache = ({} if mc is None else
                 {"attn" if kind in ATTN_KINDS else "mixer": mc})
    if cfg.post_norms:
        mix = apply_norm(params["post_norm1"], mix, cfg.norm)
    if cfg.parallel_block and kind in ATTN_KINDS:
        # x + attn(n(x)) + ff(n(x))  (cohere)
        ff, aux = _ffn(params["ff"], h, cfg, pcfg, mode)
        return x + mix + ff, new_cache or None, aux
    x = x + mix
    if "cross" in params:
        hc = apply_norm(params["norm_cross"], x, cfg.norm)
        if mode == "decode":
            enc_kv = (c["cross"]["k"], c["cross"]["v"])
            new_cache["cross"] = c["cross"]          # passed through
        else:
            enc_kv = _project_kv(params["cross"], enc_out, cfg)
            if mode == "prefill":
                new_cache["cross"] = {"k": enc_kv[0], "v": enc_kv[1]}
        mix_c, _ = attn_mixer(params["cross"], hc, cfg=cfg, pcfg=pcfg,
                              kind="cross", enc_kv=enc_kv, mode=mode)
        x = x + mix_c
    if kind != MAMBA:
        h2 = apply_norm(params["norm2"], x, cfg.norm)
        ff, aux = _ffn(params["ff"], h2, cfg, pcfg, mode)
        if cfg.post_norms:
            ff = apply_norm(params["post_norm2"], ff, cfg.norm)
        x = x + ff
    return x, new_cache or None, aux
