"""The LLM model substrate's serving path: mamba2 (`ssm`), zamba2
(`hybrid`), the dense decoders (`dense`: qwen2, stablelm, gemma2, gemma3)
and paligemma (`vlm`) prefill and decode, on the SSD intra-chunk and flash
attention kernels.  Entry point: `registry.get_model`."""
from .registry import Model, get_model

__all__ = ["Model", "get_model"]
