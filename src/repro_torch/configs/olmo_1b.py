"""olmo-1b [dense] — non-parametric LayerNorm [arXiv:2402.00838; hf].

16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304. SwiGLU, no biases,
tied embeddings, non-parametric LN (no scale/bias).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab=50304,
    pattern=("attn",),
    norm="nonparam_ln",
    ffn="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
