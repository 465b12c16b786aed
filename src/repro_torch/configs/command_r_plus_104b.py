"""command-r-plus-104b — dense 64L, GQA kv=8, parallel attn+FFN block,
LayerNorm, tied embeddings, no biases.

[hf:CohereForAI/c4ai-command-r-plus; unverified]
"""
from repro_torch.configs.base import ArchConfig, GLOBAL_ATTN

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    pattern=(GLOBAL_ATTN,),
    rope_base=75_000_000.0,
    norm="layernorm",
    parallel_block=True,
    tie_embeddings=True,
    mlp_gated=True,
    mlp_act="silu",
    source="hf:CohereForAI/c4ai-command-r-plus",
)
