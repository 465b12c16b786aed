"""gemma3-1b -- dense, 5:1 local:global hybrid attention, 128k context.

[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs.base import ArchConfig, GLOBAL_ATTN, LOCAL_ATTN

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    pattern=(LOCAL_ATTN,) * 5 + (GLOBAL_ATTN,),
    window=512,
    rope_base=10_000.0,
    rope_base_global=1_000_000.0,
    qk_norm=True,
    mlp_gated=True,
    mlp_act="gelu",
    post_norms=True,
    tie_embeddings=True,
    emb_scale=True,
    source="hf:google/gemma-3-1b-pt",
)
