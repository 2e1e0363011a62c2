"""deepseek-v2-236b [moe] — 60L d_model=5120 128H vocab=102400; MLA
(kv_lora=512), 2 shared + 160 routed experts top-6.  [arXiv:2405.04434; hf]"""
from ..models.config import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_ff=12288,
    vocab=102400, head_dim=192,
    rope_theta=10_000.0, tie_embeddings=False,
    act="silu", norm_eps=1e-6,
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536,
                  capacity_factor=1.25, router_group=512, first_dense=1),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    param_dtype="bfloat16",
    notes="MLA: decode caches only (512+64) dims/token via the absorbed "
          "form; first layer dense FFN (d_ff 12288), then 2 shared + 160 "
          "routed top-6 (10 experts/device at 16-way EP).",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                          head_dim=48, d_ff=128, vocab=256,
                          moe=MoEConfig(n_experts=8, top_k=2, n_shared=1,
                                        d_ff_expert=64, capacity_factor=1.5,
                                        router_group=64, first_dense=1),
                          mla=MLAConfig(q_lora_rank=32, kv_lora_rank=32,
                                        rope_head_dim=16, nope_head_dim=32,
                                        v_head_dim=32),
                          param_dtype="float32", compute_dtype="float32",
                          remat=False)
