"""llama4-scout-17b-a16e — 48L MoE (16 experts top-1 + shared expert),
iRoPE-style 3:1 chunked-local:global attention pattern.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ArchConfig, CHUNKED_ATTN, GLOBAL_ATTN, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    pattern=(CHUNKED_ATTN, CHUNKED_ATTN, CHUNKED_ATTN, GLOBAL_ATTN),
    window=8192,                 # attention chunk size
    rope_base=500_000.0,
    mlp_gated=True,
    mlp_act="silu",
    moe=MoEConfig(num_experts=16, top_k=1, shared_expert=True),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
