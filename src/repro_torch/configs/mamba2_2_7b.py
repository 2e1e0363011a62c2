"""mamba2-2.7b [ssm] — 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128; SSD (state-space duality).  [arXiv:2405.21060; unverified]"""
from ..models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280,
    tie_embeddings=True, act="silu", norm_eps=1e-5,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    notes="Pure SSD stack: 80 heads of P=64 (d_inner 5120); O(1) decode "
          "state => runs long_500k. Heads shard 16-way over `model`.",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(n_layers=2, d_model=64, vocab=256,
                          ssm=SSMConfig(d_state=16, d_conv=4, expand=2,
                                        head_dim=16, n_groups=1, chunk=32),
                          param_dtype="float32", compute_dtype="float32",
                          remat=False)
