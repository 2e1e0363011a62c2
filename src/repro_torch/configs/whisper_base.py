"""whisper-base [audio] — 6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865; enc-dec with conv frontend (stubbed).  [arXiv:2212.04356]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, head_dim=64,
    tie_embeddings=True, act="gelu_mlp", norm_eps=1e-5,
    enc_seq=1500, frontend_dim=512,
    notes="Encoder-decoder; mel+conv frontend stubbed (input_specs provides "
          "1500 frame embeddings). LayerNorm, absolute positions, plain GELU "
          "MLP. Decode shapes run (it is enc-dec, not encoder-only).",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
                          n_kv_heads=4, head_dim=16, d_ff=128, vocab=256,
                          enc_seq=16, frontend_dim=64,
                          param_dtype="float32", compute_dtype="float32",
                          remat=False)
