"""Functionals the GPT, Llama and BERT slices use (plain PyTorch around
the hand-written kernels, ``[B, S, H, D]`` activations and ``[B, L, nkv,
hd]`` caches as in paddle_tpu)."""
from .activation import gelu, relu, silu, tanh
from .common import dropout
from .flash_attention import (cached_attention, causal_attention,
                              flash_attention, paged_kv_cache,
                              quantized_kv_cache,
                              scaled_dot_product_attention)
from .loss import (cross_entropy, fused_linear_cross_entropy,
                   softmax_with_cross_entropy)
from .norm import layer_norm, rms_norm

__all__ = ["gelu", "relu", "silu", "tanh", "dropout", "layer_norm",
           "rms_norm", "cached_attention", "causal_attention",
           "flash_attention", "scaled_dot_product_attention",
           "quantized_kv_cache", "paged_kv_cache", "cross_entropy",
           "softmax_with_cross_entropy", "fused_linear_cross_entropy"]
