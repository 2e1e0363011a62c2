"""One model API over the architecture families (the port of the
reference's `models/registry.py`):

    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    loss = model.loss(params, {"tokens": tokens, "labels": labels})
    logits = model.prefill(params, {"tokens": tokens})         # [B,1,V] f32
    cache = model.init_cache(batch, seq)
    logits, cache = model.decode_step(params, cache, tokens[:, t:t+1], t)

`decode_step` writes the cache in place and returns it.  On a mesh
(`launch/mesh.py`), `init(..., mesh=mesh)` and `init_cache(..., mesh=mesh)`
give DTensors laid out by the specs, each rank building only its shards,
and `prefill` / `decode_step` run on them under `ctx.use_mesh(mesh)`.
For a mesh: `param_specs()`, `batch_specs(shape)` and `decode_specs(shape)` give the
reference's partition specs with tensors that hold no values (meta, or
fake under a `FakeTensorMode` with device "cpu"), and `abstract_params()`
the parameter tree as such tensors (launch/dryrun.py).  `init` and
`init_cache` take `device=` and default to "cuda"; the tensors' device
decides whether the kernels or their plain versions run.  Serving
(`prefill`, `decode_step`) runs under `torch.no_grad()` and takes the
kernels; `loss` (mean next-token cross-entropy over the labels, a batch
"mask" [B, S] optional) takes each family's plain path, the port of the
reference's jnp code (`use_kernels=False`), which autograd
differentiates: no kernel has a backward, as the reference trains on its
jnp paths too.  The port serves and trains every family of the
reference: `ssm` (mamba2), `hybrid` (zamba2), `dense` (qwen2, stablelm,
gemma2, gemma3), `vlm` (paligemma, whose batch may carry "patch_embeds"
[B, P, frontend_dim]; its labels cover the text tokens only), `moe`
(qwen3-moe, deepseek-v2; the loss adds the router's load-balancing term)
and `encdec` (whisper, whose batch carries "frames" [B, enc_seq,
d_model]; its decode cache's "cross_k" / "cross_v" are the caller's to
fill).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..distributed.ctx import P
from . import hybrid, layers, moe, ssm, transformer, whisper
from .config import ArchConfig, ShapeCell

BATCH = layers.BATCH


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    param_defs: dict
    loss: Callable          # (params, batch) -> scalar f32
    prefill: Callable       # (params, batch) -> last-position logits
    decode_step: Callable   # (params, cache, tokens[B,1], pos) -> (logits, cache)
    cache_shape: Callable   # (batch, seq) -> {name: TensorSpec}
    cache_spec: Callable    # () -> {name: P}
    forward: Callable       # (params, batch, use_kernels) -> last logits

    def init(self, generator: torch.Generator, device="cuda",
             mesh=None) -> dict:
        """Random parameters in `cfg.param_dtype` from `generator`, which
        must live on `device`.  With `mesh`, DTensors laid out by
        `param_specs()`, each rank building only its shards: the slices of
        the same draws without a mesh (`layers.init_params`)."""
        return layers.init_params(self.param_defs, generator,
                                  self.cfg.param_dtype, device, mesh)

    def compute_params(self, params: dict) -> dict:
        """`params` with each weight the forward casts to the compute type
        cast once (same results, no cast per call)."""
        return layers.cast_for_compute(self.cfg, params)

    def init_cache(self, batch: int, seq: int, device="cuda",
                   mesh=None) -> dict:
        """An empty decode cache; with `mesh`, DTensors laid out by
        `cache_spec()`, each rank allocating only its shards."""
        shapes = self.cache_shape(batch, seq)
        if mesh is None:
            return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
                    for k, s in shapes.items()}
        from ..distributed.ctx import made_on_mesh
        return {k: made_on_mesh(
            lambda box, s=shapes[k]: torch.zeros(
                [n for _, n in box], dtype=s.dtype, device=device),
            shapes[k].shape, spec, mesh)
            for k, spec in self.cache_spec().items()}

    def abstract_params(self, device="meta") -> dict:
        return layers.abstract_params(self.param_defs, self.cfg.param_dtype,
                                      device)

    def param_specs(self) -> dict:
        return layers.param_specs(self.param_defs)

    def batch_specs(self, shape: ShapeCell, device="meta"):
        """(batch of tensors without values, partition specs) for the
        train / prefill input."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def t(*dims, dtype=torch.int64):
            return torch.empty(dims, dtype=dtype, device=device)
        rows = P(BATCH, None)
        if cfg.family == "encdec":
            return ({"frames": t(b, cfg.enc_seq, cfg.d_model,
                                 dtype=torch.float32),
                     "tokens": t(b, s), "labels": t(b, s)},
                    {"frames": P(BATCH, None, None), "tokens": rows,
                     "labels": rows})
        if cfg.family == "vlm":
            st = s - cfg.n_frontend_tokens
            return ({"patch_embeds": t(b, cfg.n_frontend_tokens,
                                       cfg.frontend_dim, dtype=torch.float32),
                     "tokens": t(b, st), "labels": t(b, st)},
                    {"patch_embeds": P(BATCH, None, None), "tokens": rows,
                     "labels": rows})
        return ({"tokens": t(b, s), "labels": t(b, s)},
                {"tokens": rows, "labels": rows})

    def decode_specs(self, shape: ShapeCell, device="meta"):
        """((cache, tokens, pos), their specs) of a decode step: tensors
        without values; `pos` is a host integer (the last position)."""
        b, s = shape.global_batch, shape.seq_len
        cache = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                 for k, v in self.cache_shape(b, s).items()}
        tokens = torch.empty((b, 1), dtype=torch.int64, device=device)
        return ((cache, tokens, s - 1),
                (self.cache_spec(), P(BATCH, None), None))


_serve = torch.no_grad()


def get_model(cfg: ArchConfig) -> Model:
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return Model(
            cfg=cfg, param_defs=transformer.dense_defs(cfg),
            loss=lambda p, b: transformer.dense_loss(cfg, p, b),
            prefill=_serve(lambda p, b: transformer.dense_logits(
                cfg, p, b["tokens"], b.get("patch_embeds"), last_only=True)),
            decode_step=_serve(lambda p, c, t, pos:
                               transformer.dense_decode_step(cfg, p, c, t,
                                                             pos)),
            cache_shape=lambda b, s: transformer.dense_cache_shape(cfg, b, s),
            cache_spec=lambda: transformer.dense_cache_spec(cfg),
            forward=lambda p, b, k=True: transformer.dense_logits(
                cfg, p, b["tokens"], b.get("patch_embeds"), last_only=True,
                use_kernels=k))
    if fam == "ssm":
        return Model(
            cfg=cfg, param_defs=ssm.ssm_model_defs(cfg),
            loss=lambda p, b: ssm.ssm_loss(cfg, p, b),
            prefill=_serve(lambda p, b: ssm.ssm_logits(cfg, p, b["tokens"],
                                                       last_only=True)),
            decode_step=_serve(lambda p, c, t, pos: ssm.ssm_decode_step(
                cfg, p, c, t, pos)),
            cache_shape=lambda b, s: ssm.ssm_state_shape(cfg, b, s),
            cache_spec=lambda: ssm.ssm_state_spec(cfg),
            forward=lambda p, b, k=True: ssm.ssm_logits(
                cfg, p, b["tokens"], last_only=True, use_kernels=k))
    if fam == "hybrid":
        return Model(
            cfg=cfg, param_defs=hybrid.hybrid_model_defs(cfg),
            loss=lambda p, b: hybrid.hybrid_loss(cfg, p, b),
            prefill=_serve(lambda p, b: hybrid.hybrid_logits(
                cfg, p, b["tokens"], last_only=True)),
            decode_step=_serve(lambda p, c, t, pos: hybrid.hybrid_decode_step(
                cfg, p, c, t, pos)),
            cache_shape=lambda b, s: hybrid.hybrid_state_shape(cfg, b, s),
            cache_spec=lambda: hybrid.hybrid_state_spec(cfg),
            forward=lambda p, b, k=True: hybrid.hybrid_logits(
                cfg, p, b["tokens"], last_only=True, use_kernels=k))
    if fam == "moe":
        return Model(
            cfg=cfg, param_defs=moe.moe_model_defs(cfg),
            loss=lambda p, b: moe.moe_loss(cfg, p, b),
            prefill=_serve(lambda p, b: moe.moe_logits(
                cfg, p, b["tokens"], last_only=True)[0]),
            decode_step=_serve(lambda p, c, t, pos: moe.moe_decode_step(
                cfg, p, c, t, pos)),
            cache_shape=lambda b, s: moe.moe_cache_shape(cfg, b, s),
            cache_spec=lambda: moe.moe_cache_spec(cfg),
            forward=lambda p, b, k=True: moe.moe_logits(
                cfg, p, b["tokens"], last_only=True, use_kernels=k)[0])
    if fam == "encdec":
        return Model(
            cfg=cfg, param_defs=whisper.whisper_model_defs(cfg),
            loss=lambda p, b: whisper.whisper_loss(cfg, p, b),
            prefill=_serve(lambda p, b: whisper.decode_train(
                cfg, p, b["tokens"], whisper.encode(cfg, p, b["frames"]),
                last_only=True)),
            decode_step=_serve(lambda p, c, t, pos:
                               whisper.whisper_decode_step(cfg, p, c, t,
                                                           pos)),
            cache_shape=lambda b, s: whisper.whisper_cache_shape(cfg, b, s),
            cache_spec=lambda: whisper.whisper_cache_spec(cfg),
            forward=lambda p, b, k=True: whisper.decode_train(
                cfg, p, b["tokens"], whisper.encode(cfg, p, b["frames"], k),
                last_only=True, use_kernels=k))
    raise ValueError(f"unknown family '{fam}'")
