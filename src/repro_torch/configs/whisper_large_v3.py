"""whisper-large-v3 [audio] — encoder-decoder [arXiv:2212.04356; unverified].

32L (enc) + 32L (dec), d_model=1280 20H (kv=20) d_ff=5120 vocab=51866.
The conv frontend is a stub per the assignment: `input_specs()` provides
precomputed frame embeddings at d_model. Sinusoidal positions, LayerNorm,
GELU FFN, no RoPE. Decoder has cross-attention over the encoder output.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    pattern=("attn",),
    norm="layernorm",
    ffn="gelu",
    rope_theta=0.0,          # sinusoidal absolute positions instead
    tie_embeddings=True,
    encoder_decoder=True,
    n_enc_layers=32,
)
