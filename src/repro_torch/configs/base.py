"""Configuration dataclasses (the port's own copy of ``repro.configs.base``).

``ArchConfig`` describes a model, ``ParallelConfig`` the execution knobs
the serving and training paths read, ``TrainConfig`` the optimizer and
checkpoint schedule, ``AnalogConfig`` the SEMULATOR analog backend.  Field names and defaults
match the reference so configs read the same.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Layer kinds used in ``ArchConfig.pattern``.
GLOBAL_ATTN = "G"     # full causal self attention
LOCAL_ATTN = "L"      # sliding-window causal self attention
CHUNKED_ATTN = "C"    # block-chunked causal self attention (llama4 iRoPE)
RECURRENT = "R"       # RG-LRU recurrent block (griffin/recurrentgemma)
MAMBA = "M"           # mamba-1 selective-SSM mixer
BIDIR_ATTN = "B"      # bidirectional self attention (encoder)

ATTN_KINDS = (GLOBAL_ATTN, LOCAL_ATTN, CHUNKED_ATTN, BIDIR_ATTN)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 16
    top_k: int = 2
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    shared_expert: bool = False        # llama4-style always-on shared expert
    router_aux_coef: float = 0.01
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 mixer configuration."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                   # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or -(-d_model // 16)


@dataclass(frozen=True)
class RGLRUConfig:
    """RG-LRU recurrent block (griffin) configuration."""
    lru_width: int = 0                 # 0 -> d_model
    d_conv: int = 4


@dataclass(frozen=True)
class AnalogConfig:
    """SEMULATOR analog-crossbar execution of matmuls.

    backend: ``digital`` (plain matmul), ``emulator`` (the Conv4Xbar
    regression net), ``circuit`` (the Newton-Raphson 1T1R solver) or
    ``analytic`` (the linear expert model)."""
    enabled: bool = False
    backend: str = "emulator"
    rows: int = 64                     # crossbar wordlines per tile
    cols_per_out: int = 2              # differential pair (G+, G-)
    outs_per_block: int = 1            # MAC outputs per computing block
    g_min: float = 1e-6                # S
    g_max: float = 1e-4                # S
    v_read: float = 0.2                # V
    layers: Tuple[str, ...] = ("mlp", "attn")  # which projections run analog
    emulator_params_path: Optional[str] = None
    # gate-overdrive wordline biasing: nonzero normalized drives map into
    # [v_th/v_read, 1] so they clear the access transistor's cut-off
    wl_overdrive: bool = True
    # device non-ideality scenario name (repro_torch.nonideal registry);
    # None = the ideal corner
    scenario: Optional[str] = None


@dataclass(frozen=True)
class ParallelConfig:
    """The execution knobs the serving and training paths read.  The
    reference's mesh and sharding fields wait for ROADMAP A11; its
    ``scan_chunk`` has no counterpart (the port's recurrence has no
    tiling, ROADMAP A9)."""
    remat: str = "full"                # "none" | "full" | "dots"
    attn_block_kv: int = 1024          # blockwise-softmax KV block
    xent_chunk: int = 2048             # chunked cross-entropy seq chunk
    grad_accum: int = 1                # microbatches per step (memory knob)
    grad_compression: str = "none"     # "none" | "int8"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        # no step of the reference reads these two (its dry run, which
        # moves with the mesh, reports one): another value would silently
        # change nothing
        if self.grad_compression != "none" or self.param_dtype != "float32":
            raise NotImplementedError(
                "grad_compression and param_dtype other than their defaults "
                "are not ported yet (ROADMAP A11)")


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    z_loss: float = 1e-4
    seed: int = 0
    checkpoint_every: int = 100
    keep_checkpoints: int = 3


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                        # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # layer pattern, cycled over layers (periods stacked, remainder = tail)
    pattern: Tuple[str, ...] = (GLOBAL_ATTN,)
    window: int = 4096                 # local-attn window / chunk size
    rope_base: float = 10_000.0
    rope_base_global: float = 0.0      # 0 -> same as rope_base
    qk_norm: bool = False
    qkv_bias: bool = False
    mlp_gated: bool = True
    mlp_act: str = "silu"              # silu | gelu | relu
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    parallel_block: bool = False
    post_norms: bool = False           # gemma3 sandwich norms
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    emb_scale: bool = False            # gemma-style sqrt(d) embedding scale
    vocab_pad_to: int = 256
    encoder_layers: int = 0
    frontend: str = "none"
    frontend_tokens: int = 256
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    analog: AnalogConfig = field(default_factory=AnalogConfig)
    source: str = ""

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return -(-self.vocab_size // p) * p

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def num_periods(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def tail_kinds(self) -> Tuple[str, ...]:
        rem = self.num_layers % len(self.pattern)
        return tuple(self.pattern[:rem])


def reduced(cfg: ArchConfig, *, layers: Optional[int] = None) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests (the reference's
    ``reduced``)."""
    pat = cfg.pattern
    n_layers = layers if layers is not None else max(len(pat), 2)
    kw = dict(
        num_layers=n_layers,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        vocab_pad_to=32,
        window=max(8, min(cfg.window, 16)),
        frontend_tokens=4 if cfg.frontend != "none" else cfg.frontend_tokens,
        encoder_layers=2 if cfg.encoder_layers else 0,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=4,
                                        top_k=min(cfg.moe.top_k, 2))
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=4, dt_rank=8)
    if cfg.rglru is not None:
        kw["rglru"] = dataclasses.replace(cfg.rglru, lru_width=64)
    return dataclasses.replace(cfg, name=cfg.name + "-reduced", **kw)


def with_depth(cfg: ArchConfig, layers: int) -> ArchConfig:
    """Same widths, ``layers`` decoder layers (depth cut only)."""
    return dataclasses.replace(cfg, name=f"{cfg.name}-L{layers}",
                               num_layers=layers)
