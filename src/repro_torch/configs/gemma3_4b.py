"""gemma3-4b [dense] — 5:1 local:global attention, 128k context.

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144
[hf:google/gemma-3-1b-pt; unverified]. Local window 1024 with rope theta 10k;
global layers rope theta 1M. GeGLU FFN, embeddings scaled by sqrt(d).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262144,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024,
    norm="rmsnorm",
    ffn="geglu",
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    embed_scale=True,
    tie_embeddings=True,
)
