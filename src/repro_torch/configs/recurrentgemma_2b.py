"""recurrentgemma-2b — griffin hybrid: (RG-LRU, RG-LRU, local-attn) pattern,
MQA head_dim 256, window 2048.

[arXiv:2402.19427; hf]
"""
from repro_torch.configs.base import ArchConfig, LOCAL_ATTN, RECURRENT, RGLRUConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    pattern=(RECURRENT, RECURRENT, LOCAL_ATTN),
    window=2048,
    rope_base=10_000.0,
    mlp_gated=True,
    mlp_act="gelu",
    tie_embeddings=True,
    emb_scale=True,
    rglru=RGLRUConfig(lru_width=2560, d_conv=4),
    source="arXiv:2402.19427",
)
