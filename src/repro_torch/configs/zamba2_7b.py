"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64; Mamba2 backbone + weight-shared attention blocks.
[arXiv:2411.15242; unverified]"""
from ..models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, head_dim=112,
    tie_embeddings=True, act="silu", norm_eps=1e-5,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=2,
                  chunk=256),
    attn_every=6,
    notes="81 mamba2 blocks; ONE weight-shared attn+MLP block invoked after "
          "every 6th mamba block (13 sites) through per-site linear "
          "adapters; 3 trailing mamba blocks. O(1)+13-site KV decode state "
          "=> runs long_500k (shared KV seq axis sharded over `model`).",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(n_layers=7, d_model=64, n_heads=4, n_kv_heads=4,
                          head_dim=16, d_ff=128, vocab=256, attn_every=3,
                          ssm=SSMConfig(d_state=16, d_conv=4, expand=2,
                                        head_dim=16, n_groups=1, chunk=32),
                          param_dtype="float32", compute_dtype="float32",
                          remat=False)
