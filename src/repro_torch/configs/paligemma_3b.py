"""paligemma-3b [vlm] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216; SigLIP + gemma backbone.  [arXiv:2407.07726; hf]

The SigLIP vision tower is a STUB per the assignment: input_specs() provides
256 precomputed patch embeddings of width 1152 that a learned projection maps
into the gemma text stream."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab=257216, head_dim=256,
    rope_theta=10_000.0, tie_embeddings=True,
    act="gelu", norm_eps=1e-6,
    frontend_dim=1152, n_frontend_tokens=256,
    notes="gemma-1 style backbone with MQA (kv=1); 256 SigLIP patch tokens "
          "prepended via a learned 1152->2048 projection (frontend stubbed).",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
                          head_dim=16, d_ff=128, vocab=256,
                          frontend_dim=32, n_frontend_tokens=8,
                          param_dtype="float32", compute_dtype="float32",
                          remat=False)
