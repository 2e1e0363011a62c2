"""stablelm-1.6b [dense] — 24L d_model=2048 32H (kv=32, MHA) d_ff=5632
vocab=100352.  [hf:stabilityai/stablelm-2-1_6b; unverified]

stablelm-2 details: LayerNorm (not RMSNorm), partial rotary (25%), qkv bias,
untied embeddings."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab=100352, head_dim=64,
    qkv_bias=True, rope_theta=10_000.0, tie_embeddings=False,
    act="silu", norm_eps=1e-5,
    notes="MHA (kv=32); 32 heads shard cleanly over the 16-way model axis.",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          head_dim=16, d_ff=128, vocab=256,
                          param_dtype="float32", compute_dtype="float32",
                          remat=False)
