"""Functionals the GPT serving slice uses (plain PyTorch, ``[B, S, H, D]``
activations and ``[B, L, nkv, hd]`` caches as in paddle_tpu)."""
from .activation import gelu
from .flash_attention import (cached_attention, causal_attention,
                              quantized_kv_cache)
from .norm import layer_norm

__all__ = ["gelu", "layer_norm", "cached_attention", "causal_attention",
           "quantized_kv_cache"]
