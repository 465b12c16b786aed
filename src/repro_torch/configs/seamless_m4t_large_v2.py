"""seamless-m4t-large-v2 — encoder-decoder multimodal backbone (24L enc +
24L dec, MHA kv=16). Audio frontend is a STUB providing precomputed frame
embeddings.

[arXiv:2308.11596; hf]
"""
from repro_torch.configs.base import ArchConfig, GLOBAL_ATTN

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    pattern=(GLOBAL_ATTN,),
    rope_base=10_000.0,
    norm="layernorm",
    mlp_gated=False,
    mlp_act="gelu",
    encoder_layers=24,
    frontend="audio",
    source="arXiv:2308.11596",
)
