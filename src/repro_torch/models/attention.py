"""Attention: GQA projections (with qwen's optional q/k/v biases) +
blockwise-softmax attention in plain PyTorch (port of
``repro.models.attention``).

Prefill uses a flat-head layout (B, S, Hq, D) with KV repeated to Hq
heads; decode keeps the grouped (B, S, Hkv, D) cache.  Decode writes the
new key/value into the cache IN PLACE (the reference's functional update
donates the old cache; here the session owns the buffers).  Under
``ParallelConfig.decode_seq_shard`` on a mesh's model axis each rank
holds ``S_max / tp`` of a global layer's cache and decode combines the
ranks' partial softmaxes (``sharded_flash_decode``).

  global  : causal, blockwise online softmax over KV blocks
  local   : exact sliding window (2-chunk trick when S is a multiple of
            the window, else the masked blockwise path)
  chunked : llama4's causal attention within the query's own chunk of
            ``cfg.window`` positions (1-chunk trick when S is a multiple
            of the chunk, else the masked blockwise path)
  bidir   : the encoder's self attention (rope, no mask)
  cross   : the decoder's attention to the encoder's keys and values
            (no rope, no mask; decode reads them from the cross cache)
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import (ArchConfig, BIDIR_ATTN, CHUNKED_ATTN,
                                      GLOBAL_ATTN, LOCAL_ATTN)
from repro_torch.models.common import (P, ParamSchema, apply_norm,
                                       apply_rope, axis_size, current_mesh,
                                       dense, dense_schema, einsum,
                                       mesh_coords, norm_schema)

NEG_INF = -1e30


def attention_schema(cfg: ArchConfig, *, cross: bool = False):
    """A ``cross`` block (the decoder's attention to the encoder) has no
    q/k/v biases."""
    d, qf = cfg.d_model, cfg.num_heads * cfg.head_dim
    kvf = cfg.num_kv_heads * cfg.head_dim
    s = {"wq": dense_schema(d, qf), "wk": dense_schema(d, kvf),
         "wv": dense_schema(d, kvf),
         "wo": dense_schema(qf, d, fsdp="model", tp="data")}
    if cfg.qkv_bias and not cross:
        s["bq"] = ParamSchema((qf,), "zeros", spec=P("model"))
        s["bk"] = ParamSchema((kvf,), "zeros", spec=P(None))
        s["bv"] = ParamSchema((kvf,), "zeros", spec=P(None))
    if cfg.qk_norm:
        s["qnorm"] = norm_schema(cfg.head_dim, "rmsnorm")
        s["knorm"] = norm_schema(cfg.head_dim, "rmsnorm")
    return s


def _project_q(params, x, cfg: ArchConfig):
    B, S, _ = x.shape
    q = dense(x, params["wq"], "attn.q")
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    if "qnorm" in params:
        q = apply_norm(params["qnorm"], q, "rmsnorm")
    return q


def _project_kv(params, x, cfg: ArchConfig):
    B, S, _ = x.shape
    k = dense(x, params["wk"], "attn.k")
    v = dense(x, params["wv"], "attn.v")
    if "bk" in params:
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if "knorm" in params:
        k = apply_norm(params["knorm"], k, "rmsnorm")
    return k, v


def _repeat_kv(k, cfg: ArchConfig):
    g = cfg.num_heads // cfg.num_kv_heads
    if g == 1:
        return k
    B, S, Hkv, D = k.shape
    return k[:, :, :, None].expand(B, S, Hkv, g, D).reshape(B, S, Hkv * g, D)


def _out_proj(params, o, cfg: ArchConfig):
    B, S = o.shape[:2]
    o = o.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return dense(o, params["wo"], "attn.o")


def flash_attention(q, k, v, *, causal: bool = True, block_kv: int = 1024,
                    window: int = 0, chunk: int = 0) -> torch.Tensor:
    """Causal attention, optionally within a sliding ``window`` or within
    the query's own ``chunk``; with ``causal=False`` every key is seen
    (the encoder, the cross attention).  q: (B,Sq,H,D); k,v: (B,Sk,H,D)
    head-repeated.  Blockwise online softmax over KV blocks (a Python loop
    in place of the reference's scan).  Returns (B,Sq,H,D) in v's dtype."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    bk = min(block_kv, Sk)
    if Sk % bk != 0:                   # pad KV; padded keys are masked out
        pad = bk - Sk % bk
        k = torch.cat([k, k.new_zeros((B, pad, H, D))], dim=1)
        v = torch.cat([v, v.new_zeros((B, pad, H, D))], dim=1)
    kv_len = Sk
    Sk = k.shape[1]
    q = q * (D ** -0.5)
    dev = q.device
    q_pos = torch.arange(Sq, device=dev)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    o = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)
    for b in range(Sk // bk):
        kb, vb = k[:, b * bk:(b + 1) * bk], v[:, b * bk:(b + 1) * bk]
        s = einsum("bqhd,bkhd->bhqk", q, kb).float()
        k_pos = b * bk + torch.arange(bk, device=dev)
        if causal:
            mask = k_pos[None, :] <= q_pos[:, None]
            if window:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            if chunk:
                mask &= (q_pos[:, None] // chunk) == (k_pos[None, :] // chunk)
            s = torch.where(mask[None, None], s, NEG_INF)
        elif kv_len != Sk:             # only the padded keys are masked
            s = torch.where((k_pos < kv_len)[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = einsum("bhqk,bkhd->bhqd", p.to(vb.dtype), vb)
        o = o * alpha[..., None] + pv.float()
        m = m_new
    o = o / torch.clamp_min(l, 1e-20)[..., None]
    return o.permute(0, 2, 1, 3).to(v.dtype)


def _grouped_windowed(q, k, v, w: int, *, sliding: bool):
    """Attention over (B,S,H,D) reshaped to chunks of ``w`` positions.
    ``sliding``: each chunk's queries see their own chunk and the previous
    one, within ``w`` positions (local attention); else only their own
    chunk, causally (llama4's chunked attention)."""
    B, S, H, D = q.shape
    n = S // w

    def to5(x):  # (B,S,H,D) -> (B,n,H,w,D)
        return x.reshape(B, n, w, H, D).permute(0, 1, 3, 2, 4)

    q5, k5, v5 = to5(q), to5(k), to5(v)
    if sliding:
        kp = torch.cat([torch.zeros_like(k5[:, :1]), k5[:, :-1]], dim=1)
        vp = torch.cat([torch.zeros_like(v5[:, :1]), v5[:, :-1]], dim=1)
        k5 = torch.cat([kp, k5], dim=3)               # (B,n,H,2w,D)
        v5 = torch.cat([vp, v5], dim=3)
    wk = k5.shape[3]
    dev = q.device
    k_pos = torch.arange(wk, device=dev)[None, :]
    if sliding:
        q_pos = torch.arange(w, device=dev)[:, None] + w  # in the 2w frame
        valid = (k_pos <= q_pos) & (q_pos - k_pos < w)        # (w, 2w)
        nz = torch.arange(n, device=dev) > 0                  # chunk 0: no prev
        mask_n = valid[None] & (nz[:, None, None] | (k_pos >= w)[None])
    else:
        q_pos = torch.arange(w, device=dev)[:, None]
        mask_n = (k_pos <= q_pos)[None].expand(n, w, wk)
    s = einsum("bnhqd,bnhkd->bnhqk", q5 * (D ** -0.5), k5).float()
    s = torch.where(mask_n[None, :, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o5 = einsum("bnhqk,bnhkd->bnhqd", p.to(v5.dtype), v5)
    return o5.permute(0, 1, 3, 2, 4).reshape(B, S, H, D)


def local_attention(q, k, v, window: int):
    S = q.shape[1]
    if window >= S or S % window != 0:
        return flash_attention(q, k, v, block_kv=min(1024, S),
                               window=window if window < S else 0)
    return _grouped_windowed(q, k, v, window, sliding=True)


def chunked_attention(q, k, v, chunk: int):
    """llama4-style: causal attention restricted to the query's own chunk."""
    S = q.shape[1]
    if chunk >= S or S % chunk != 0:
        return flash_attention(q, k, v, block_kv=min(1024, S),
                               chunk=chunk if chunk < S else 0)
    return _grouped_windowed(q, k, v, chunk, sliding=False)


def decode_attention(q, ck, cv, valid_mask, cfg: ArchConfig):
    """q: (B,1,Hq,D); ck/cv: (B,S,Hkv,D); valid_mask: (S,) -- one mask for
    every row, all at one position -- or (B,S) -- each row its own, at
    its own position (continuous batching)."""
    B, D = q.shape[0], q.shape[-1]
    g = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(B, 1, cfg.num_kv_heads, g, D)
    s = einsum("bqhgd,bkhd->bhgqk", qg * (D ** -0.5), ck).float()
    if valid_mask.dim() == 1:
        valid_mask = valid_mask[None]
    s = torch.where(valid_mask[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = einsum("bhgqk,bkhd->bhgqd", p.to(cv.dtype), cv)
    return o.permute(0, 3, 1, 2, 4).reshape(B, 1, cfg.num_heads, D)


def sharded_flash_decode(q, ck, cv, pos, cfg: ArchConfig, *, mesh=None,
                         tp_axis: str = "model"):
    """Flash-decode with the cache's sequence sharded over ``tp_axis``:
    ck/cv (B, S_max/tp, Hkv, D) are this rank's block of a global layer's
    cache, slots ``[t * S_local, (t+1) * S_local)``; q (B, 1, Hq, D) is
    the same on every rank.  Each rank takes a partial softmax over its
    block (the positions ``<= pos`` valid, ``pos`` an int or a (B,) /
    (B, 1) tensor); the partials combine by an ``all_reduce`` MAX of m
    over the axis, then SUM of ``l * corr`` and ``o * corr``
    (``corr = exp(m - M)``).  Without a mesh, or on an axis of one rank,
    it is ``decode_attention`` over the whole cache."""
    B, D = q.shape[0], q.shape[-1]
    n_loc = ck.shape[1]
    dev = q.device
    pos = (pos.to(dev, torch.int64).reshape(-1, 1) if isinstance(
        pos, torch.Tensor) else torch.full((1, 1), int(pos), device=dev))
    tp = axis_size(tp_axis, mesh) if mesh is not None else 1
    if tp <= 1:
        return decode_attention(q, ck, cv,
                                torch.arange(n_loc, device=dev)[None] <= pos,
                                cfg)
    off = mesh_coords(mesh)[tp_axis] * n_loc
    g = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(B, 1, cfg.num_kv_heads, g, D)
    s = einsum("bqhgd,bkhd->bhgqk", qg * (D ** -0.5), ck).float()
    valid = (torch.arange(n_loc, device=dev)[None] + off) <= pos   # (B|1, S)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = einsum("bhgqk,bkhd->bhgqd", p.to(cv.dtype), cv).float()
    from repro_torch.parallel.train_mesh import model_reduce
    M = model_reduce(m.clone(), mesh, "max")
    corr = torch.exp(m - M)
    L = model_reduce(l * corr, mesh)
    O = model_reduce(o * corr[..., None], mesh)
    out = O / torch.clamp_min(L, 1e-20)[..., None]
    out = out.permute(0, 3, 1, 2, 4)
    return out.reshape(B, 1, cfg.num_heads, D).to(cv.dtype)


def rope_base_for(cfg: ArchConfig, kind: str) -> float:
    if kind == GLOBAL_ATTN and cfg.rope_base_global:
        return cfg.rope_base_global
    return cfg.rope_base


def attn_mixer(params, x, *, cfg: ArchConfig, pcfg, kind: str,
               positions=None, cache=None, pos=None, enc_kv=None,
               mode: str = "train"):
    """Returns (out (B,S,D), new_cache_or_None).  Cache layout:
      global/bidir : {"k","v"}: (B, S_max, Hkv, Dh), position p at slot p
      local/chunked : ring buffer (B, W, Hkv, Dh), slot = p mod W
      cross : none; ``enc_kv`` = (k, v), each (B, S_enc, Hkv, Dh), the
              encoder's projected keys and values (``blocks.apply_layer``
              keeps them in the layer's cross cache)
    ``pos`` (decode) is the position being written: an int, every row at
    it, or a (B,) tensor, each row at its own (continuous batching: each
    row writes its own slot and masks its own history)."""
    B, S, _ = x.shape
    base = rope_base_for(cfg, kind)
    q = _project_q(params, x, cfg)
    dev = x.device

    if kind == "cross":
        k, v = enc_kv
        Sk = k.shape[1]
        o = flash_attention(q, _repeat_kv(k.to(q.dtype), cfg),
                            _repeat_kv(v.to(q.dtype), cfg), causal=False,
                            block_kv=min(pcfg.attn_block_kv, Sk))
        return _out_proj(params, o, cfg), None

    if mode == "decode":
        # one path for both forms: an int is every row at that position
        pos = (pos.to(dev, torch.int64) if isinstance(pos, torch.Tensor)
               else torch.full((B,), int(pos), dtype=torch.int64, device=dev))
        pos = pos.expand(B)[:, None]                  # (B, 1)
        q = apply_rope(q, pos, base)
        k, v = _project_kv(params, x, cfg)
        k = apply_rope(k, pos, base)
        ck, cv = cache["k"], cache["v"]
        n_slots = ck.shape[1]
        mesh = current_mesh()
        if (kind == GLOBAL_ATTN and getattr(pcfg, "decode_seq_shard", False)
                and mesh is not None and axis_size("model", mesh) > 1):
            # this rank holds slots [t * n, (t+1) * n) of the cache: it
            # writes the rows whose position falls there
            loc = pos[:, 0] - mesh_coords(mesh)["model"] * n_slots
            mine = (loc >= 0) & (loc < n_slots)
            ck[mine, loc[mine]] = k[mine, 0].to(ck.dtype)
            cv[mine, loc[mine]] = v[mine, 0].to(cv.dtype)
            o = sharded_flash_decode(q, ck, cv, pos, cfg, mesh=mesh,
                                     tp_axis=getattr(pcfg, "tp_axis", "model"))
            return _out_proj(params, o, cfg), {"k": ck, "v": cv}
        slot = pos % n_slots                          # (B, 1)
        rows = torch.arange(B, device=dev)
        ck[rows, slot[:, 0]] = k[:, 0].to(ck.dtype)   # in place, see docstring
        cv[rows, slot[:, 0]] = v[:, 0].to(cv.dtype)
        idx = torch.arange(n_slots, device=dev)[None, :]
        if kind == GLOBAL_ATTN:
            valid = idx <= pos
        else:
            abs_pos = pos - ((slot - idx) % n_slots)  # position held in slot
            if kind == LOCAL_ATTN:
                valid = ((abs_pos >= 0) & (abs_pos > pos - n_slots)
                         & (abs_pos <= pos))
            else:                                     # same chunk as pos
                valid = ((abs_pos >= 0) & (abs_pos // n_slots == pos // n_slots)
                         & (abs_pos <= pos))
        o = decode_attention(q, ck, cv, valid, cfg)
        return _out_proj(params, o, cfg), {"k": ck, "v": cv}

    if positions is None:
        positions = torch.arange(S, device=dev)[None, :]
    q = apply_rope(q, positions, base)
    k, v = _project_kv(params, x, cfg)
    k = apply_rope(k, positions, base)
    kf, vf = _repeat_kv(k, cfg), _repeat_kv(v, cfg)
    if kind == LOCAL_ATTN:
        o = local_attention(q, kf, vf, cfg.window)
    elif kind == CHUNKED_ATTN:
        o = chunked_attention(q, kf, vf, cfg.window)
    else:
        o = flash_attention(q, kf, vf, causal=kind != BIDIR_ATTN,
                            block_kv=min(pcfg.attn_block_kv, S))
    new_cache = None
    if mode == "prefill":
        if kind in (GLOBAL_ATTN, BIDIR_ATTN):
            new_cache = {"k": k, "v": v}
        else:
            W = min(cfg.window, S)
            new_cache = {"k": k[:, -W:], "v": v[:, -W:]}
    return _out_proj(params, o, cfg), new_cache


def attn_cache_schema(cfg: ArchConfig, kind: str, batch: int, s_max: int,
                      dtype=torch.bfloat16, *, seq_shard: bool = False):
    """{"k", "v"}: (shape, dtype, spec) of one attention layer's decode
    cache; ``seq_shard`` places a global layer's sequence on model."""
    size = s_max if kind == GLOBAL_ATTN else min(cfg.window, s_max)
    seq_axis = "model" if (seq_shard and kind == GLOBAL_ATTN) else None
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    spec = P(("pod", "data"), seq_axis, None, None)
    return {"k": (shape, dtype, spec), "v": (shape, dtype, spec)}
