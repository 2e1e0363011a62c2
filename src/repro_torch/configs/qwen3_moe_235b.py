"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) vocab=151936,
MoE 128 experts top-8, expert d_ff=1536.  [hf:Qwen/Qwen3-*; hf]"""
from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
    vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=False,
    act="silu", norm_eps=1e-6,
    moe=MoEConfig(n_experts=128, top_k=8, n_shared=0, d_ff_expert=1536,
                  capacity_factor=1.25, router_group=512),
    param_dtype="bfloat16",
    notes="128 routed experts top-8, no shared expert; experts shard over "
          "`model` (8/device at 16-way EP) + FSDP d_model over `data`. "
          "~235B total / ~22B active.",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=64, vocab=256,
                          moe=MoEConfig(n_experts=8, top_k=2, n_shared=0,
                                        d_ff_expert=64, capacity_factor=1.5,
                                        router_group=64),
                          param_dtype="float32", compute_dtype="float32",
                          remat=False)
