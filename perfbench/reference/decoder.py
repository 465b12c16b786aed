"""The decoder families of the benchmark's configurations, plainly: a
prompt's prefill and one decode step of a batch through a KV cache.

Layer: layernorm -> GQA attention (rope, causal) -> residual -> norm -> FFN
-> residual, or with ``parallel_block`` (cohere) x + attn(n(x)) +
ffn(n(x)).  The FFN is a gated MLP or a mixture of experts (softmax
router, top-k, gates renormalized over the k, GShard capacity: each
expert takes at most C = max(4, ceil4(T * k * f / E)) of a call's T
tokens' assignments, in token-major order, the rest dropped).  The
projections whose tag starts with one of ``analog_layers`` run through
``emulator.AnalogRef``; every other product is a bf16 matmul.

Numerics are the configuration's: parameters and activations bf16;
norms' statistics, the router, softmax and the logits float32; rope's
angles float32 and its products bf16.  ``params`` is the nested dict
the benchmark made (one stacked period ``decoder.scan.p0`` holding every
layer on its leading axis); ``cfg`` a plain dict of sizes.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def plain_config(cfg, conf: Dict) -> Dict:
    """The plain sizes this module reads: from ``cfg``, the port's config
    of the configuration file ``conf`` (read by attribute; the harness
    holds its widths to the file's), and from the file.  Raises
    ``SystemExit`` for a configuration this module does not model: a
    layer other than global attention without q/k/v biases or norms,
    layernorm and a silu FFN; analog projections on a backend other than
    the emulator (``emulator.AnalogRef``), or at a device corner other
    than the ideal one.  A configuration that needs more names a
    reference module of its own."""
    backend = conf.get("backend", "emulator")
    why = []
    if set(cfg.pattern) != {"G"} or cfg.tail_kinds or cfg.qkv_bias \
            or cfg.qk_norm or cfg.mlp_act != "silu" \
            or cfg.norm != "layernorm":
        why.append(f"{cfg.name} is not global attention without q/k/v "
                   "biases or norms, layernorm and a silu FFN")
    if backend not in ("emulator", "digital"):
        why.append(f"the {backend!r} backend is not the emulator")
    if conf.get("corner"):
        why.append("a device corner is not the ideal one")
    if why:
        raise SystemExit(f"{conf['name']}: the reference 'decoder' cannot "
                         f"check it: {'; '.join(why)}")
    return {"num_layers": cfg.num_layers, "d_model": cfg.d_model,
            "d_ff": cfg.d_ff, "num_heads": cfg.num_heads,
            "num_kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
            "vocab_size": cfg.vocab_size, "padded_vocab": cfg.padded_vocab,
            "rope_base": cfg.rope_base,
            "parallel_block": cfg.parallel_block,
            "tie_embeddings": cfg.tie_embeddings,
            "mlp_gated": cfg.mlp_gated,
            "analog_layers": ([] if backend == "digital"
                              else list(conf["analog_layers"])),
            "moe": (None if cfg.moe is None else {
                "num_experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
                "eval_capacity_factor": cfg.moe.eval_capacity_factor})}


def kv_layers(cache: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The program's KV cache (the harness's capture of it, a nested dict)
    as this family's every layer's keys and values, each (L, slots,
    S_max, Hkv, Dh): one stacked period of attention layers."""
    att = cache["scan"]["p0"]["attn"]
    return att["k"], att["v"]


def layernorm(x, w, b, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w.float()
            + b.float()).to(x.dtype)


def norm(p, x):
    return layernorm(x, p["w"], p["b"])


def fp8(t):
    """``t`` read at fp8 (e4m3, scaled by its largest magnitude), in its
    own dtype: the control's operands of every digital product."""
    s = t.abs().amax().float().clamp_min(1e-30) / 448.0
    return ((t.float() / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)


def silu(x):
    return x * (1.0 / (1.0 + torch.exp(-x)))


def rope(x, positions, base):
    """Split-half rotation of (B, S, H, D) at (B|1, S) positions."""
    half = x.shape[-1] // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = (positions[..., None].float() * freqs)[..., None, :]
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Decoder:
    """``prefill(tokens)`` and ``decode(tok, cache, pos)`` of ``cfg`` on
    ``params``; ``analog.matmul(x, w, key)`` computes each analog
    projection (``key`` = (layer, tag)).  ``low`` reads every digital
    product's operands at fp8 (the control: the nearest precision below
    the configuration's bf16)."""

    def __init__(self, cfg: Dict, params: Dict, analog, low: bool = False):
        assert not params["decoder"].get("tail"), "one stacked period only"
        self.cfg, self.p, self.analog = cfg, params, analog
        self.q = fp8 if low else (lambda t: t)
        self.layers = params["decoder"]["scan"]["p0"]
        self.n = cfg["num_layers"]

    def _leaf(self, tree, i):
        return {k: (self._leaf(v, i) if isinstance(v, dict) else v[i])
                for k, v in tree.items()}

    def _dense(self, x, w, tag, i):
        if any(tag.startswith(a) for a in self.cfg["analog_layers"]):
            return self.analog.matmul(x, w, key=(i, tag))
        return torch.matmul(self.q(x), self.q(w.to(x.dtype)))

    def _qkv(self, lp, x, i, positions):
        c = self.cfg
        B, S, _ = x.shape
        q = self._dense(x, lp["wq"], "attn.q", i).reshape(
            B, S, c["num_heads"], c["head_dim"])
        k = self._dense(x, lp["wk"], "attn.k", i).reshape(
            B, S, c["num_kv_heads"], c["head_dim"])
        v = self._dense(x, lp["wv"], "attn.v", i).reshape(
            B, S, c["num_kv_heads"], c["head_dim"])
        return (rope(q, positions, c["rope_base"]),
                rope(k, positions, c["rope_base"]), v)

    def _attn_prefill(self, lp, x, i):
        c = self.cfg
        B, S, _ = x.shape
        D = c["head_dim"]
        pos = torch.arange(S, device=x.device)[None, :]
        q, k, v = self._qkv(lp, x, i, pos)
        g = c["num_heads"] // c["num_kv_heads"]
        kf = k[:, :, :, None].expand(B, S, k.shape[2], g, D).reshape(
            B, S, -1, D)
        vf = v[:, :, :, None].expand(B, S, v.shape[2], g, D).reshape(
            B, S, -1, D)
        s = torch.einsum("bqhd,bkhd->bhqk", self.q(q * (D ** -0.5)),
                         self.q(kf)).float()
        causal = pos[0][None, :] <= pos[0][:, None]
        s = torch.where(causal[None, None], s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = torch.einsum("bhqk,bkhd->bhqd", self.q(p.to(vf.dtype)),
                         self.q(vf)).float()
        o = (o / torch.clamp_min(p.sum(dim=-1), 1e-20)[..., None])
        o = o.permute(0, 2, 1, 3).to(v.dtype).reshape(B, S, -1)
        return self._dense(o, lp["wo"], "attn.o", i), (k, v)

    def _attn_decode(self, lp, x, i, ck, cv, pos):
        c = self.cfg
        B, D = x.shape[0], c["head_dim"]
        q, k, v = self._qkv(lp, x, i, pos[:, None])
        rows = torch.arange(B, device=x.device)
        slot = pos % ck.shape[1]
        ck[rows, slot] = k[:, 0].to(ck.dtype)
        cv[rows, slot] = v[:, 0].to(cv.dtype)
        valid = (torch.arange(ck.shape[1], device=x.device)[None]
                 <= pos[:, None])
        hk = c["num_kv_heads"]
        qg = q.reshape(B, 1, hk, c["num_heads"] // hk, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", self.q(qg * (D ** -0.5)),
                         self.q(ck)).float()
        s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bhgqd", self.q(p.to(cv.dtype)),
                         self.q(cv))
        o = o.permute(0, 3, 1, 2, 4).reshape(B, 1, -1)
        return self._dense(o, lp["wo"], "attn.o", i)

    def _ffn(self, lp, x, i):
        c = self.cfg
        if c.get("moe"):
            return self._moe(lp, x)
        up = self._dense(x, lp["w_up"], "mlp.up", i)
        gate = self._dense(x, lp["w_gate"], "mlp.gate", i)
        return self._dense(silu(gate) * up, lp["w_down"], "mlp.down", i)

    def _moe(self, lp, x):
        m = self.cfg["moe"]
        B, S, Dm = x.shape
        T, E, K = B * S, m["num_experts"], m["top_k"]
        C = max(4, -(-int(T * K * m["eval_capacity_factor"] / E) // 4) * 4)
        xt = x.reshape(T, Dm)
        probs = torch.softmax(xt.float() @ lp["router"].float(), dim=-1)
        gates, experts = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
        gates, experts = gates[:, :K], experts[:, :K]
        if K > 1:
            gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        onehot = F.one_hot(experts, E)                          # (T, K, E)
        flat = onehot.reshape(T * K, E)
        rank = ((torch.cumsum(flat, dim=0) - flat).reshape(T, K, E)
                * onehot).sum(-1)
        keep = rank < C
        slot = torch.where(keep, experts * C + rank,
                           torch.full_like(rank, E * C - 1)).reshape(-1)
        xk = xt[:, None].expand(T, K, Dm).reshape(T * K, Dm)
        xk = xk * keep.reshape(-1, 1).to(xt.dtype)
        buf = xt.new_zeros((E * C, Dm)).index_add(0, slot, xk).reshape(
            E, C, Dm)
        q = self.q
        up = torch.bmm(q(buf), q(lp["w_up"].to(buf.dtype)))
        h = silu(torch.bmm(q(buf), q(lp["w_gate"].to(buf.dtype)))) * up
        yb = torch.bmm(q(h), q(lp["w_down"].to(h.dtype))).reshape(E * C, Dm)
        yk = yb[slot].reshape(T, K, Dm)
        y = (yk * (gates * keep).to(yk.dtype)[..., None]).sum(dim=1)
        return y.reshape(B, S, Dm)

    def _layer(self, i, x, attn):
        lp = self._leaf(self.layers, i)
        h = norm(lp["norm1"], x)
        mix, kv = attn(lp["attn"], h, i)
        if self.cfg["parallel_block"]:
            return x + mix + self._ffn(lp["ff"], h, i), kv
        x = x + mix
        return x + self._ffn(lp["ff"], norm(lp["norm2"], x), i), kv

    def _logits(self, h):
        c, p = self.cfg, self.p
        h = norm(p["final_norm"], h)
        if c["tie_embeddings"]:
            lg = torch.einsum("bsd,vd->bsv", self.q(h),
                              self.q(p["embed"].to(h.dtype)))
        else:
            lg = torch.matmul(self.q(h), self.q(p["head"].to(h.dtype)))
        lg = lg.float()
        pad = torch.arange(lg.shape[-1], device=lg.device) >= c["vocab_size"]
        return torch.where(pad[None, None], NEG_INF, lg)[:, -1]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, ...]]]:
        """tokens (1, P) -> (last position's logits (1, Vp) float32, each
        layer's (k, v), (1, P, Hkv, Dh) after rope)."""
        x = self.p["embed"][tokens].to(torch.bfloat16)
        kvs = []
        for i in range(self.n):
            x, kv = self._layer(i, x, lambda lp, h, j: self._attn_prefill(
                lp, h, j))
            kvs.append(kv)
        return self._logits(x[:, -1:]), kvs

    @torch.no_grad()
    def decode(self, tok: torch.Tensor, cache: List[Tuple[torch.Tensor, ...]],
               pos: torch.Tensor) -> torch.Tensor:
        """One step of B rows: tok (B, 1), each row at its own ``pos``
        (B,); ``cache`` each layer's (k, v), (B, S_max, Hkv, Dh), written
        in place at the rows' positions.  Returns the logits (B, Vp)."""
        x = self.p["embed"][tok].to(torch.bfloat16)
        for i in range(self.n):
            ck, cv = cache[i]
            x, _ = self._layer(i, x, lambda lp, h, j: (self._attn_decode(
                lp, h, j, ck, cv, pos), None))
        return self._logits(x)
