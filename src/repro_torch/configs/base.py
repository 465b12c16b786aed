"""Configuration dataclasses (the port's own copy of ``repro.configs.base``).

``ArchConfig`` describes a model, ``ShapeConfig`` a workload shape (the
dry run's ``SHAPES``), ``ParallelConfig`` the execution knobs the serving
and training paths read, ``TrainConfig`` the optimizer and checkpoint
schedule, ``AnalogConfig`` the SEMULATOR analog backend.  Field names and defaults
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
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                          # "train" | "prefill" | "decode"


# The four assigned workload shapes (identical for every LM arch).
SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclass(frozen=True)
class ParallelConfig:
    """The execution knobs the serving and training paths read.

    Mesh axis names: the batch is sharded over (pod, data); weights over
    (data = fsdp, model = tp); experts and a big KV cache's sequence over
    model (``models.common`` places each leaf by its schema's spec).
    ``residual_seq_shard`` keeps the residual stream between layers, and
    so the remat stash, sequence-sharded over model outside decode
    (Megatron-SP); ``decode_seq_shard`` holds each model rank's
    ``S_max / tp`` of a global layer's KV cache (flash-decode).  The
    reference's ``scan_layers`` and ``scan_chunk`` have no counterpart:
    the port's period loop is a Python loop and its recurrence has no
    tiling."""
    fsdp_axis: str = "data"
    tp_axis: str = "model"
    pod_axis: str = "pod"
    remat: str = "full"                # "none" | "full" | "dots"
    attn_block_kv: int = 1024          # blockwise-softmax KV block
    attn_block_q: int = 1024
    xent_chunk: int = 2048             # chunked cross-entropy seq chunk
    decode_seq_shard: bool = False     # shard KV-cache seq dim over model
    residual_seq_shard: bool = False   # Megatron-SP residual stream
    grad_accum: int = 1                # microbatches per step (memory knob)
    grad_compression: str = "none"     # "none" | "int8"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        # no step of the reference reads these two (its dry run reports
        # one): another value would silently change nothing, so it is
        # refused (ROADMAP A11 struck their wiring)
        if self.grad_compression != "none" or self.param_dtype != "float32":
            raise NotImplementedError(
                "grad_compression and param_dtype other than their defaults "
                "are read by no step of the reference, and are refused "
                "(ROADMAP A11)")


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

    @property
    def sub_quadratic(self) -> bool:
        """True if decode over very long context is O(1)/O(window) for most
        layers (SSM / hybrid / windowed) -> long_500k applies."""
        return all(k != GLOBAL_ATTN for k in self.pattern) or (
            sum(k == GLOBAL_ATTN for k in self.pattern) < len(self.pattern) // 2
        )

    def supports_shape(self, shape: ShapeConfig) -> bool:
        if shape.name == "long_500k":
            return self.sub_quadratic
        return True

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included; the
        reference's formula)."""
        d, f = self.d_model, self.d_ff
        qf = self.num_heads * self.head_dim
        kvf = self.num_kv_heads * self.head_dim
        attn = d * qf + 2 * d * kvf + qf * d
        mlp = d * f * (3 if self.mlp_gated else 2)
        total = 0
        for kind in self.layer_kinds:
            if kind in ATTN_KINDS:
                total += attn
                if self.moe is not None:
                    e = self.moe.num_experts + (1 if self.moe.shared_expert else 0)
                    total += e * mlp + d * self.moe.num_experts
                else:
                    total += mlp
            elif kind == RECURRENT:
                w = (self.rglru.lru_width or d) if self.rglru else d
                total += 2 * d * w + w * d + 3 * w + mlp
            elif kind == MAMBA:
                di = d * self.ssm.expand
                dtr = self.ssm.resolved_dt_rank(d)
                total += (d * 2 * di + di * (dtr + 2 * self.ssm.d_state)
                          + dtr * di + di * d + di * self.ssm.d_conv
                          + di * self.ssm.d_state + di)
        total += self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        if self.encoder_layers:
            # encoder self-attn + ffn, decoder cross-attn
            total += self.encoder_layers * (attn + mlp)
            total += self.num_layers * attn      # cross attention
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp = d * f * (3 if self.mlp_gated else 2)
        e_total = self.moe.num_experts + (1 if self.moe.shared_expert else 0)
        e_active = self.moe.top_k + (1 if self.moe.shared_expert else 0)
        n_moe_layers = sum(1 for k in self.layer_kinds if k in ATTN_KINDS)
        return self.param_count() - n_moe_layers * (e_total - e_active) * mlp


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
    """Same widths, ``layers`` decoder layers (depth cut only; an
    encoder-decoder arch keeps its ``encoder_layers``)."""
    return dataclasses.replace(cfg, name=f"{cfg.name}-L{layers}",
                               num_layers=layers)
