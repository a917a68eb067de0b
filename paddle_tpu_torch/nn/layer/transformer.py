"""Transformer layers (port of paddle_tpu/nn/layer/transformer.py):
``MultiHeadAttention`` with its ``Cache`` / ``StaticCache`` for
incremental decoding, the encoder and decoder layers and stacks, and
``Transformer``.

Attention goes through ``F.scaled_dot_product_attention`` as in
paddle_tpu, on ``[B, S, H, D]``: without a mask and without attention
dropout it runs the hand-written flash-attention kernels (B1) forward and
backward; a mask takes the plain masked branch (a bool mask first becomes
an additive -1e9 mask in the query's dtype, ``_convert_attention_mask``),
and so does attention dropout in training.

One deliberate difference: ``gen_cache``'s empty incremental ``Cache``
starts at the key's dtype and device, where paddle_tpu's starts in f32
(torch would promote a bf16 decode to f32 at the first concatenation).
"""
from __future__ import annotations

import collections
import copy

import torch

from ...device import param_device
from .. import functional as F
from ..layer_base import Layer
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _convert_attention_mask(attn_mask, dtype):
    """A bool keep-mask -> an additive mask (0 where kept, -1e9 where
    not) in ``dtype``; any other mask as it is."""
    if attn_mask is None:
        return None
    if attn_mask.dtype == torch.bool:
        return torch.where(attn_mask, 0.0, -1e9).to(dtype)
    return attn_mask


class MultiHeadAttention(Layer):
    """Multi-head attention over ``[B, S, embed_dim]``: ``q_proj`` /
    ``k_proj`` / ``v_proj`` / ``out_proj`` ``Linear`` layers around
    ``F.scaled_dot_product_attention``. ``cache``: a ``Cache`` (k and v
    so far, extended by this call's and returned) or a ``StaticCache``
    (k and v computed once, e.g. from an encoder's memory)."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _split_heads(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        """``StaticCache``: the projected heads of ``key`` / ``value``
        (default ``key``); else with ``value`` None an empty ``Cache``
        ``[B, 0, H, D]`` (at key's dtype and device), or ``Cache(key,
        value)``."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(
                value if value is not None else key))
            return self.StaticCache(k, v)
        if value is None:
            empty = key.new_zeros((key.shape[0], 0, self.num_heads,
                                   self.head_dim))
            return self.Cache(empty, empty.clone())
        return self.Cache(key, value)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._split_heads(self.q_proj(query))        # (b, s, h, d)
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = self.Cache(k, v)
        mask = _convert_attention_mask(attn_mask, q.dtype)
        if mask is not None:
            mask = mask.to(q.device)
            if mask.ndim == 3:
                mask = mask.unsqueeze(1)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask,
            dropout_p=self.dropout if self.training else 0.0)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(None)
        if cache is not None:
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


class TransformerEncoderLayer(Layer):
    """Self-attention and a feed-forward block, each with a residual,
    dropout and LayerNorm (after, or before with ``normalize_before``)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src, type=MultiHeadAttention.Cache)


def _clones(layer, num_layers):
    """``layer`` and ``num_layers - 1`` deep copies of it (the same
    initial weights in every layer, as paddle_tpu builds its stacks)."""
    return LayerList([layer] + [copy.deepcopy(layer)
                                for _ in range(num_layers - 1)])


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, src_mask)
            else:
                output, c = layer(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """Self-attention, cross-attention over the encoder's memory and a
    feed-forward block; ``cache`` is an ``(incremental Cache,
    StaticCache)`` pair (``gen_cache``)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm3 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incr = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
            if isinstance(tgt, tuple):
                tgt = tgt[0]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr, cache[1]))

    def gen_cache(self, memory):
        incr = self.self_attn.gen_cache(memory, type=MultiHeadAttention.Cache)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incr, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, memory, tgt_mask, memory_mask)
            else:
                output, c = layer(output, memory, tgt_mask, memory_mask,
                                  cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        caches = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*caches)) if do_zip else caches


class Transformer(Layer):
    """The encoder-decoder transformer, at Transformer-base's geometry by
    default (d_model 512, 8 heads, 6 + 6 layers, FFN 2048, relu); a
    LayerNorm after each stack with ``normalize_before``."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        """The ``[length, length]`` bool causal keep-mask (True on and
        below the diagonal), where layers build their parameters
        (``device.param_device``)."""
        return torch.ones(length, length, dtype=torch.bool,
                          device=param_device()).tril()
