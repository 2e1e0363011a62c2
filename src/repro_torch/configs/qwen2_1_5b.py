"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936; GQA, QKV bias.  [arXiv:2407.10671; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151936, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
    act="silu", norm_eps=1e-6,
    notes="GQA kv=2 with QKV bias; 12 heads do not divide the 16-way model "
          "axis, so baseline attention weights replicate over `model` "
          "(hillclimb target).",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab=256,
                          param_dtype="float32", compute_dtype="float32",
                          remat=False)
