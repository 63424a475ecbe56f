"""ArchConfig: one declarative description of every assigned architecture
(port of `repro.models.config`).

The ``pattern`` tuple is cycled over layers: gemma3's 5:1 local:global is
``("local",)*5 + ("attn",)``; Griffin's 2:1 recurrent:attention is
``("rglru", "rglru", "local")``; Mamba-2 is ``("ssm",)``. Every field and
derived value is the JAX package's; ``pdtype`` / ``cdtype`` are torch dtypes.

`MoEDims`, `SSMDims` and `RGLRUDims` are copies of the JAX package's frozen
dataclasses (from `repro.nn.moe`, `repro.nn.ssm`, `repro.nn.rglru`), kept
here so that every config loads and `model_param_count` counts every
family; `repro_torch.nn.moe`, `repro_torch.nn.ssm` and
`repro_torch.nn.rglru` take theirs from here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.nn.attention import AttnDims

VOCAB_PAD = 256  # pad vocab to a multiple (shardable over the model axis)


@dataclasses.dataclass(frozen=True)
class MoEDims:
    """Copy of `repro.nn.moe.MoEDims`."""

    d_model: int
    n_experts: int
    top_k: int
    d_ff: int                 # per-expert hidden dim
    n_shared: int = 0         # shared (always-on) experts
    capacity_factor: float = 1.25
    ffn: str = "swiglu"


@dataclasses.dataclass(frozen=True)
class SSMDims:
    """Copy of `repro.nn.ssm.SSMDims`."""

    d_model: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


@dataclasses.dataclass(frozen=True)
class RGLRUDims:
    """Copy of `repro.nn.rglru.RGLRUDims`."""

    d_model: int
    d_rnn: int
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    pattern: Tuple[str, ...] = ("attn",)
    window: int = 0                  # for "local" blocks
    qkv_bias: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm | nonparam_ln
    ffn: str = "swiglu"              # swiglu | geglu | gelu
    rope_theta: float = 10000.0
    rope_theta_local: Optional[float] = None
    embed_scale: bool = False        # multiply embeddings by sqrt(d_model)
    tie_embeddings: bool = True
    attn_softcap: float = 0.0
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_d_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # RG-LRU
    rnn_width: int = 0
    # enc-dec (whisper)
    encoder_decoder: bool = False
    n_enc_layers: int = 0
    # multimodal stub prefix (internvl2 patches / whisper frames are inputs)
    prefix_len: int = 0
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # ------------------------------------------------------------ derived

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // VOCAB_PAD) * VOCAB_PAD

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_types(self) -> Tuple[str, ...]:
        """Block type of every layer (pattern cycled)."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def attn_dims(self, local: bool) -> AttnDims:
        theta = self.rope_theta
        if local and self.rope_theta_local is not None:
            theta = self.rope_theta_local
        return AttnDims(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.resolved_head_dim,
            qkv_bias=self.qkv_bias,
            rope_theta=theta,
            window=self.window if local else 0,
            causal=True,
            softcap=self.attn_softcap,
        )

    def enc_attn_dims(self) -> AttnDims:
        d = self.attn_dims(local=False)
        return dataclasses.replace(d, causal=False, rope_theta=0.0)

    def moe_dims(self) -> MoEDims:
        return MoEDims(
            d_model=self.d_model,
            n_experts=self.n_experts,
            top_k=self.moe_top_k,
            d_ff=self.moe_d_ff,
            n_shared=self.n_shared_experts,
            capacity_factor=self.capacity_factor,
            ffn=self.ffn,
        )

    def ssm_dims(self) -> SSMDims:
        return SSMDims(
            d_model=self.d_model,
            d_state=self.ssm_d_state,
            head_dim=self.ssm_head_dim,
            expand=self.ssm_expand,
            chunk=self.ssm_chunk,
        )

    def rglru_dims(self) -> RGLRUDims:
        return RGLRUDims(d_model=self.d_model,
                         d_rnn=self.rnn_width or self.d_model)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def scaled_down(self, **overrides) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        scale = {
            "n_layers": min(self.n_layers, 2 * max(1, len(self.pattern))),
            "d_model": 128,
            "n_heads": max(2, min(self.n_heads, 4)),
            "n_kv_heads": max(1, min(self.n_kv_heads, 2)),
            "head_dim": 32,
            "d_ff": 256,
            "vocab": 512,
            "window": min(self.window, 64) if self.window else 0,
            "rnn_width": 128 if self.rnn_width else 0,
            "ssm_d_state": 32 if self.ssm_d_state else 0,
            "ssm_head_dim": 32,
            "ssm_chunk": 32,
            "n_experts": min(self.n_experts, 4),
            "moe_top_k": min(self.moe_top_k, 2),
            "moe_d_ff": 64 if self.moe_d_ff else 0,
            "n_shared_experts": min(self.n_shared_experts, 1),
            "n_enc_layers": min(self.n_enc_layers, 2),
            "prefix_len": min(self.prefix_len, 8),
            "compute_dtype": "float32",
        }
        scale.update(overrides)
        return dataclasses.replace(self, **scale)


def model_param_count(cfg: ArchConfig) -> int:
    """Approximate parameter count (the JAX package's MODEL_FLOPS term)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
    dense_ffn = d * cfg.d_ff * (3 if cfg.ffn in ("swiglu", "geglu") else 2)
    moe_ffn = cfg.n_experts * d * cfg.moe_d_ff * 3 + d * cfg.n_experts
    moe_ffn += cfg.n_shared_experts * d * cfg.moe_d_ff * 3
    ssm = 0
    if cfg.ssm_d_state:
        sd = cfg.ssm_dims()
        ssm = d * (2 * sd.d_inner + 2 * sd.n_groups * sd.d_state + sd.n_heads)
        ssm += sd.d_inner * d
    rglru = 0
    if cfg.rnn_width:
        r = cfg.rnn_width
        rglru = 2 * d * r + 2 * r * r + r * d

    total = 0
    for lt in cfg.layer_types():
        if lt in ("attn", "local"):
            total += attn + (moe_ffn if cfg.is_moe else dense_ffn)
        elif lt == "rglru":
            total += rglru + dense_ffn
        elif lt == "ssm":
            total += ssm
    if cfg.encoder_decoder:
        # encoder layers: attn + ffn; decoder cross-attn extra
        total += cfg.n_enc_layers * (attn + dense_ffn)
        total += cfg.n_layers * attn  # cross attention
    total += cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2)
    return total
