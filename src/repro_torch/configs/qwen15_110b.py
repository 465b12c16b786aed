"""qwen1.5-110b — dense 80L, GQA kv=8, QKV bias.

[hf:Qwen/Qwen1.5-110B (family config per assignment); hf]
"""
from repro_torch.configs.base import ArchConfig, GLOBAL_ATTN

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    pattern=(GLOBAL_ATTN,),
    rope_base=1_000_000.0,
    qkv_bias=True,
    mlp_gated=True,
    mlp_act="silu",
    source="hf:Qwen/Qwen1.5-110B",
)
