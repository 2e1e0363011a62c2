"""One model API over the architecture families (the port of the
reference's `models/registry.py`, its serving half):

    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    logits = model.prefill(params, {"tokens": tokens})         # [B,1,V] f32
    cache = model.init_cache(batch, seq)
    logits, cache = model.decode_step(params, cache, tokens[:, t:t+1], t)

`decode_step` writes the cache in place and returns it.  `init` and
`init_cache` take `device=` and default to "cuda"; the tensors' device
decides whether the kernels or their plain versions run.  The port serves
the `ssm` (mamba2) and `hybrid` (zamba2) families; the others, and
training (`loss`), raise NotImplementedError naming the ROADMAP item they
wait for.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from . import hybrid, layers, ssm
from .config import ArchConfig

_WAITS = {
    "dense": "dense decoders (attention_traced_window) wait for ROADMAP "
             "Queue 1 item 6b",
    "vlm": "the VLM family (attention_traced_window) waits for ROADMAP "
           "Queue 1 item 6b",
    "moe": "the MoE family (models/moe.py) waits for ROADMAP Queue 1 item 6c",
    "encdec": "the encoder-decoder family (models/whisper.py) waits for "
              "ROADMAP Queue 1 item 6d",
}


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    param_defs: dict
    prefill: Callable       # (params, batch) -> last-position logits
    decode_step: Callable   # (params, cache, tokens[B,1], pos) -> (logits, cache)
    cache_shape: Callable   # (batch, seq) -> {name: TensorSpec}

    def init(self, generator: torch.Generator, device="cuda") -> dict:
        """Random parameters in `cfg.param_dtype` from `generator`, which
        must live on `device`."""
        return layers.init_params(self.param_defs, generator,
                                  self.cfg.param_dtype, device)

    def compute_params(self, params: dict) -> dict:
        """`params` with each weight the forward casts to the compute type
        cast once (same results, no cast per call)."""
        return layers.cast_for_compute(self.cfg, params)

    def init_cache(self, batch: int, seq: int, device="cuda") -> dict:
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
                for k, s in self.cache_shape(batch, seq).items()}

    def loss(self, params, batch):
        raise NotImplementedError(
            "training (loss, train/) waits for ROADMAP Queue 1 item 6e; the "
            "port serves (prefill, decode_step) only")


def get_model(cfg: ArchConfig) -> Model:
    fam = cfg.family
    if fam == "ssm":
        return Model(
            cfg=cfg, param_defs=ssm.ssm_model_defs(cfg),
            prefill=lambda p, b: ssm.ssm_logits(cfg, p, b["tokens"],
                                                last_only=True),
            decode_step=lambda p, c, t, pos: ssm.ssm_decode_step(
                cfg, p, c, t, pos),
            cache_shape=lambda b, s: ssm.ssm_state_shape(cfg, b, s))
    if fam == "hybrid":
        return Model(
            cfg=cfg, param_defs=hybrid.hybrid_model_defs(cfg),
            prefill=lambda p, b: hybrid.hybrid_logits(cfg, p, b["tokens"],
                                                      last_only=True),
            decode_step=lambda p, c, t, pos: hybrid.hybrid_decode_step(
                cfg, p, c, t, pos),
            cache_shape=lambda b, s: hybrid.hybrid_state_shape(cfg, b, s))
    if fam in _WAITS:
        raise NotImplementedError(f"{cfg.name}: {_WAITS[fam]}")
    raise ValueError(f"unknown family '{fam}'")
