"""The LLM model substrate's serving path: mamba2 (`ssm`) and zamba2
(`hybrid`) prefill and decode, on the SSD intra-chunk and flash attention
kernels.  Entry point: `registry.get_model`."""
from .registry import Model, get_model

__all__ = ["Model", "get_model"]
