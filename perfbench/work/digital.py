"""Operations of the digital model, per token, from the configuration's
shapes: 2 per multiply-add of every product the token needs.

Counted: the projections that do not run analog (an analog projection's
work is B1's, ``work.b1``), attention's score and value products over
the positions the token sees, the MoE router and the experts the token
is routed to (top-k of them, never all), a dense MLP, and the logits of
the tokens whose logits are computed (each decoded token, a prefill's
last position).  Norms, rope and the activations are elementwise and
left out.
"""
from __future__ import annotations

from typing import Iterable


def _analog(cfg: dict, tag: str) -> bool:
    return any(tag.startswith(p) for p in cfg["analog_layers"])


def token_flops(cfg: dict, pos: int) -> int:
    """Digital operations of one token at position ``pos`` (0-based)
    through every layer, the logits excluded."""
    d, f = cfg["d_model"], cfg["d_ff"]
    hq, dh = cfg["num_heads"], cfg["head_dim"]
    qf, kvf = hq * dh, cfg["num_kv_heads"] * dh
    gated = cfg.get("mlp_gated", True)
    per = 4 * hq * dh * (pos + 1)                      # q.k and p.v
    for tag, k, n in (("attn.q", d, qf), ("attn.k", d, kvf),
                      ("attn.v", d, kvf), ("attn.o", qf, d)):
        if not _analog(cfg, tag):
            per += 2 * k * n
    mlp = 2 * d * f * (3 if gated else 2)
    moe = cfg.get("moe")
    if moe:
        per += 2 * d * moe["num_experts"] + moe["top_k"] * mlp
    elif not _analog(cfg, "mlp.up"):
        per += mlp
    return cfg["num_layers"] * per


def logits_flops(cfg: dict) -> int:
    return 2 * cfg["d_model"] * cfg["vocab_size"]


def prefill_flops(cfg: dict, n: int) -> int:
    """A prompt of ``n`` tokens: every position, and one row of logits."""
    return sum(token_flops(cfg, p) for p in range(n)) + logits_flops(cfg)


def decode_flops(cfg: dict, positions: Iterable[int]) -> int:
    """One tick's live rows, each at its own position, each with logits."""
    return sum(token_flops(cfg, p) + logits_flops(cfg) for p in positions)
