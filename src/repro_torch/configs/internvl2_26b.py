"""internvl2-26b [vlm] — InternViT frontend (stub) + InternLM2-20B backbone.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553 [arXiv:2404.16821; hf].
The ViT frontend is an input stub per the assignment: `input_specs()` feeds
precomputed patch embeddings (prefix_len=256 patches) at d_model.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92553,
    pattern=("attn",),
    norm="rmsnorm",
    ffn="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    prefix_len=256,
)
