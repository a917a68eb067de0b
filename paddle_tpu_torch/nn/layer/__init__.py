"""Layers (port of paddle_tpu/nn/layer/: the common, normalisation,
activation, container and transformer layers)."""
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .common import Dropout, Embedding, Linear
from .container import LayerDict, LayerList, ParameterList, Sequential
from .norm import LayerNorm, RMSNorm
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["Linear", "Embedding", "Dropout", "LayerNorm", "RMSNorm",
           "Sequential", "LayerList", "ParameterList", "LayerDict",
           "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"] + list(_activation)
