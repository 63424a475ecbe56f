"""phi3-mini-3.8b [dense] — RoPE SwiGLU MHA [arXiv:2404.14219; unverified].

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab=32064,
    pattern=("attn",),
    norm="rmsnorm",
    ffn="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
)
