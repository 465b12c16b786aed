"""falcon-mamba-7b — pure mamba-1, 64 mixer layers, attention-free.

[arXiv:2410.05355; unverified]
"""
from repro_torch.configs.base import ArchConfig, MAMBA, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=65024,
    pattern=(MAMBA,),
    mlp_gated=False,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    source="arXiv:2410.05355",
)
