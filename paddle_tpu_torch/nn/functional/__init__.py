"""Functionals (plain PyTorch around the hand-written kernels, ``[B, S,
H, D]`` activations and ``[B, L, nkv, hd]`` caches as in paddle_tpu):
what the port has of paddle_tpu/nn/functional/."""
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .common import dropout
from .flash_attention import (cached_attention, causal_attention,
                              flash_attention, flash_attn_unpadded,
                              paged_kv_cache, quantized_kv_cache,
                              scaled_dot_product_attention, sdp_kernel)
from .loss import (cross_entropy, fused_linear_cross_entropy,
                   softmax_with_cross_entropy)
from .norm import layer_norm, rms_norm

__all__ = list(_activation) + [
    "dropout", "layer_norm", "rms_norm", "cached_attention",
    "causal_attention", "flash_attention", "flash_attn_unpadded",
    "scaled_dot_product_attention", "sdp_kernel", "quantized_kv_cache",
    "paged_kv_cache", "cross_entropy", "softmax_with_cross_entropy",
    "fused_linear_cross_entropy"]
