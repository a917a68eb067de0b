"""Layers (port of paddle_tpu/nn/layer/: the ones the GPT, Llama and
BERT slices use)."""
from .activation import Tanh
from .common import Dropout, Embedding, Linear
from .norm import LayerNorm, RMSNorm

__all__ = ["Linear", "Embedding", "Dropout", "LayerNorm", "RMSNorm", "Tanh"]
