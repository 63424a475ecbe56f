"""recurrentgemma-2b [hybrid] — Griffin RG-LRU + local attention, 2:1 pattern.

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000 [arXiv:2402.19427; hf].
Pattern: (rglru, rglru, local-attn) repeating; local window 2048; GeGLU FFN;
RG-LRU width = d_model. Long-context capable (bounded state + window).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    pattern=("rglru", "rglru", "local"),
    window=2048,
    norm="rmsnorm",
    ffn="geglu",
    rope_theta=10_000.0,
    embed_scale=True,
    tie_embeddings=True,
    rnn_width=2560,
)
