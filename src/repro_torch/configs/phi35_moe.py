"""phi3.5-moe-42b-a6.6b — 32L MoE, 16 experts top-2, GQA kv=8.

[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from repro_torch.configs.base import ArchConfig, GLOBAL_ATTN, MoEConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    pattern=(GLOBAL_ATTN,),
    rope_base=10_000.0,
    mlp_gated=True,
    mlp_act="silu",
    norm="layernorm",
    moe=MoEConfig(num_experts=16, top_k=2),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
