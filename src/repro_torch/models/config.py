"""Architecture configuration for the model pool (a copy of the reference
package's `models/config.py`, field for field, so configs compare equal).

One frozen (hashable) dataclass describes every architecture family: dense
decoders (qwen2 / stablelm / gemma2 / gemma3 and the paligemma backbone),
SSMs (mamba2), MoE decoders (qwen3-moe, deepseek-v2 with MLA), hybrids
(zamba2), and the whisper encoder-decoder.  The port serves the `ssm` and
`hybrid` families (`models/registry.py`); the others are data only.

`reduced()` in each config module derives the small variant of the same
family (few layers, narrow width, tiny vocab) that the CPU tests use.

Fields that steer the reference's sharding, remat and layer scan
(`remat`, `remat_policy`, `scan_layers`, `seq_shard_residual`,
`attn_block`, `attn_impl`) are kept so the configs compare, and mean
nothing to the port: it runs on one device, eagerly, and routes attention
by the tensor's device (`models/layers.attention`), not by `attn_impl`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts (0 = dense FFN)
    top_k: int = 0
    n_shared: int = 0             # always-on shared experts (deepseek)
    d_ff_expert: int = 0          # per-expert hidden size
    capacity_factor: float = 1.25
    router_group: int = 512       # tokens per dispatch group (compile-time)
    first_dense: int = 0          # leading layers that keep a dense FFN
    dispatch: str = "einsum"      # einsum (GShard one-hot) | sort (argsort +
                                  # gather/scatter: no dispatch matmul FLOPs)


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    q_lora_rank: int = 0          # 0 = full-rank Q projection
    kv_lora_rank: int = 512
    rope_head_dim: int = 64       # decoupled RoPE dims per head
    nope_head_dim: int = 128      # content dims per head
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64            # P: channels per SSD head
    n_groups: int = 1             # B/C projection groups
    chunk: int = 256              # SSD chunk length


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | ssm | moe | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    # --- attention details ---
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0        # gemma2 final-logit softcap
    attn_softcap: float = 0.0         # gemma2 attention softcap
    sliding_window: int = 0           # window size for local layers
    local_pattern: int = 0            # N -> (N-1) local : 1 global; 2 -> alternate
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"                 # silu (SwiGLU) | gelu (GeGLU) | gelu_mlp
    parallel_block: bool = False      # stablelm-style parallel attn+mlp? (no)
    post_norm: bool = False           # gemma2 post-attn/post-ffn extra norms
    # --- family extensions ---
    moe: MoEConfig = MoEConfig()
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    attn_every: int = 0               # hybrid: shared attn block period (zamba2)
    n_enc_layers: int = 0             # encdec: encoder depth (whisper)
    enc_seq: int = 0                  # encdec: encoder frames after conv stub
    frontend_dim: int = 0             # vlm/audio stub: embedding dim fed in
    n_frontend_tokens: int = 0        # vlm: image patch tokens prepended
    # --- numerics / training ---
    param_dtype: str = "float32"      # big archs use bfloat16
    compute_dtype: str = "bfloat16"
    remat: bool = True                # activation checkpointing on layer scan
    remat_policy: str = "nothing"     # nothing | dots (save matmul outputs:
                                      # less recompute traffic, more memory)
    scan_layers: bool = True          # False: unroll (dry-run FLOP counting)
    attn_block: int = 512             # q-block size for blockwise attention
                                      # (0 = materialize full S^2 scores)
    attn_impl: str = "xla"            # reference only: xla | flash; the port
                                      # routes attention by device instead
    seq_shard_residual: bool = False  # Megatron-SP: shard the residual
                                      # stream's sequence axis over `model`
                                      # between layers (norms/elementwise
                                      # compute and traffic / mesh_model)
    # embodied metadata for the STEAM digital-twin bridge
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows: odd vocabs (whisper 51865, mamba2 50280) are
        padded to a multiple of 256 so the vocab axis shards over `model`;
        logits_out masks the pad columns."""
        return self.vocab if self.vocab % 16 == 0 else -(-self.vocab // 256) * 256

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k decode (SSM/hybrid state-space decoders)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def n_params(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS and memory estimates)."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        per = 0
        if self.family == "ssm":
            per = _ssm_params(self)
            total = emb + self.n_layers * per + d
        elif self.family == "hybrid":
            ssm_p = _ssm_params(self)
            n_attn = self.n_layers // max(self.attn_every, 1)
            # zamba2: ONE weight-shared attention+mlp block reused at every
            # attn site (counted once), plus per-site linear adapters.
            shared = _attn_params(self) + _ffn_params(self, self.d_ff)
            adapters = n_attn * (2 * d * d)
            total = emb + self.n_layers * ssm_p + shared + adapters + d
        elif self.family == "encdec":
            enc = self.n_enc_layers * (_attn_params(self) + _ffn_params(self, self.d_ff))
            dec = self.n_layers * (2 * _attn_params(self) + _ffn_params(self, self.d_ff))
            total = emb + enc + dec + 2 * d
        else:
            per = _attn_params(self) + _layer_ffn_params(self)
            total = emb + self.n_layers * per + d
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k + shared experts count)."""
        if self.moe.n_experts == 0:
            return self.n_params()
        expert = _ffn_params(self, self.moe.d_ff_expert)
        n_moe_layers = self.n_layers - self.moe.first_dense
        inactive = (self.moe.n_experts - self.moe.top_k) * expert
        return self.n_params() - n_moe_layers * inactive


def _attn_params(cfg: ArchConfig) -> int:
    d, hd = cfg.d_model, cfg.hd
    if cfg.mla is not None:
        m = cfg.mla
        q_in = m.q_lora_rank or d
        qp = (d * m.q_lora_rank if m.q_lora_rank else 0) + \
            q_in * cfg.n_heads * (m.nope_head_dim + m.rope_head_dim)
        kvp = d * (m.kv_lora_rank + m.rope_head_dim) + \
            m.kv_lora_rank * cfg.n_heads * (m.nope_head_dim + m.v_head_dim)
        op = cfg.n_heads * m.v_head_dim * d
        return qp + kvp + op
    return d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d


def _ffn_params(cfg: ArchConfig, d_ff: int) -> int:
    mult = 3 if cfg.act in ("silu", "gelu") else 2   # gated acts have 3 mats
    return mult * cfg.d_model * d_ff


def _layer_ffn_params(cfg: ArchConfig) -> int:
    if cfg.moe.n_experts == 0:
        return _ffn_params(cfg, cfg.d_ff)
    expert = _ffn_params(cfg, cfg.moe.d_ff_expert)
    router = cfg.d_model * cfg.moe.n_experts
    return (cfg.moe.n_experts + cfg.moe.n_shared) * expert + router


def _ssm_params(cfg: ArchConfig) -> int:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    n_heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    in_proj = d * (2 * d_in + 2 * s.n_groups * s.d_state + n_heads)
    return in_proj + conv_dim * s.d_conv + n_heads * 2 + d_in + d_in * d


# --------------------------------------------------------------------------
# input shapes (the 4 assigned shape cells)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ArchConfig, shape: ShapeCell) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic decoders."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "long_500k skipped: pure full-attention arch (quadratic)"
    return True, ""
