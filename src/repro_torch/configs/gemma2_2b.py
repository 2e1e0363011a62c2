"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000;
local+global alternating attention, logit softcap.  [arXiv:2408.00118; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_ff=9216,
    vocab=256000, head_dim=256,
    rope_theta=10_000.0, tie_embeddings=True,
    act="gelu", norm_eps=1e-6,
    logit_softcap=30.0, attn_softcap=50.0,
    sliding_window=4096, local_pattern=2,   # alternating local/global
    post_norm=True,                          # extra post-attn/post-ffn norms
    notes="Alternating 4k-local/global attention; attn softcap 50, final "
          "logit softcap 30; scaled embeddings; (1+w) RMSNorm.",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab=256, sliding_window=8,
                          param_dtype="float32", compute_dtype="float32",
                          remat=False)
