"""moonshot-v1-16b-a3b [moe] — kimi/moonlight style, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B; hf].

48L d_model=2048 16H (kv=16) expert d_ff=1408 vocab=163840, MoE 64e top-6,
plus 2 shared (always-on) experts (DeepSeek-V3/Moonlight style).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=163840,
    pattern=("attn",),
    norm="rmsnorm",
    ffn="swiglu",
    rope_theta=50_000.0,
    tie_embeddings=False,
    n_experts=64,
    moe_top_k=6,
    moe_d_ff=1408,
    n_shared_experts=2,
    capacity_factor=1.25,
)
