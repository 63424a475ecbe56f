"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct; hf].

32L d_model=4096 32H (GQA kv=8) expert d_ff=6400 vocab=32064, MoE 16e top-2.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,               # nominal (experts hold the FFN capacity)
    vocab=32064,
    pattern=("attn",),
    norm="rmsnorm",
    ffn="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    n_experts=16,
    moe_top_k=2,
    moe_d_ff=6400,
    capacity_factor=1.25,
)
