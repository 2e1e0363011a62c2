"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144; 5:1 local:global, 128k context.  [hf:google/gemma-3; unverified]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10240,
    vocab=262144, head_dim=256,
    rope_theta=1_000_000.0, tie_embeddings=True,
    act="gelu", norm_eps=1e-6,
    qk_norm=True,                       # gemma3 replaces softcaps with qk-norm
    sliding_window=1024, local_pattern=6,   # 5 local : 1 global
    post_norm=True,
    notes="5:1 local(1024):global pattern; qk-norm; no softcaps (gemma3 "
          "dropped them); global layers use 1M rope theta.",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab=256, sliding_window=8,
                          param_dtype="float32", compute_dtype="float32",
                          remat=False)
