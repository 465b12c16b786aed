"""deepseek-coder-33b — dense 62L llama-arch, GQA kv=8.

[arXiv:2401.14196; hf]
"""
from repro_torch.configs.base import ArchConfig, GLOBAL_ATTN

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    pattern=(GLOBAL_ATTN,),
    rope_base=100_000.0,
    mlp_gated=True,
    mlp_act="silu",
    source="arXiv:2401.14196",
)
