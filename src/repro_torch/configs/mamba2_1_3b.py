"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060; unverified].

48L d_model=2048 (attention-free) vocab=50280, ssm_state=128, expand=2,
head_dim=64 (=> 64 heads). Long-context capable (constant-size state).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,               # attention-free; SSM heads derive from expand
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    pattern=("ssm",),
    norm="rmsnorm",
    rope_theta=0.0,
    tie_embeddings=True,
    ssm_d_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
)
