"""internvl2-76b — VLM: InternViT frontend (STUB: precomputed patch
embeddings) + 80L llama-3-70B-class language backbone.

[arXiv:2404.16821; unverified]
"""
from repro_torch.configs.base import ArchConfig, GLOBAL_ATTN

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    pattern=(GLOBAL_ATTN,),
    rope_base=500_000.0,
    mlp_gated=True,
    mlp_act="silu",
    frontend="vision",
    frontend_tokens=256,
    source="arXiv:2404.16821",
)
