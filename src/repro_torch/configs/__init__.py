"""Architecture registry: arch id -> ArchConfig (copies of the reference
package's `configs/`, equal field for field).

`ARCHS` maps the architecture ids to their full published configs;
`reduced(id)` returns the family-preserving small variant.  The port serves
the `ssm` and `hybrid` families (mamba2-2.7b, zamba2-7b); `get_model`
refuses the others.
"""
from __future__ import annotations

from ..models.config import ArchConfig, SHAPES, ShapeCell, cell_applicable

from . import (deepseek_v2_236b, gemma2_2b, gemma3_4b, mamba2_2_7b,
               paligemma_3b, qwen2_1_5b, qwen3_moe_235b, stablelm_1_6b,
               whisper_base, zamba2_7b)

_MODULES = {
    "qwen2-1.5b": qwen2_1_5b,
    "stablelm-1.6b": stablelm_1_6b,
    "gemma2-2b": gemma2_2b,
    "gemma3-4b": gemma3_4b,
    "mamba2-2.7b": mamba2_2_7b,
    "paligemma-3b": paligemma_3b,
    "whisper-base": whisper_base,
    "qwen3-moe-235b-a22b": qwen3_moe_235b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "zamba2-7b": zamba2_7b,
}

ARCHS: dict[str, ArchConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
ARCH_IDS = list(ARCHS)


def get_config(arch_id: str) -> ArchConfig:
    try:
        return ARCHS[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch '{arch_id}'; known: {ARCH_IDS}") from None


def reduced(arch_id: str) -> ArchConfig:
    return _MODULES[arch_id].reduced()


__all__ = ["ARCHS", "ARCH_IDS", "SHAPES", "ShapeCell", "cell_applicable",
           "get_config", "reduced"]
