"""GPT decoder family (port of paddle_tpu/models/gpt.py): serving and
training.

Parameter names and layouts match paddle_tpu's, so weights carry across by
name with no transpose: Linear weights stay ``[in, out]`` and apply as
``x @ W + b``; the ``[3H]`` qkv output is laid out ``[q(H); k(H); v(H)]``;
the LM head is tied to the word embedding.

Ported: the cached forward (prefill and per-row decode, the serving
path, over slot caches or the paged pools of ``new_paged_cache``), the
no-cache forward on the flash-attention kernels (training and
evaluation) or, when the mesh has an ``sp`` axis above 1, on
``ring_attention`` (the blockwise kernels, B5), ``loss_fn`` /
``make_loss_fn`` on the fused cross-entropy kernels, and ``train()`` /
``bfloat16()`` (torch's own, which cast every float parameter as
paddle_tpu's ``Layer.bfloat16()`` does). The training memory features:
``recompute`` / ``recompute_policy`` (each block through
``distributed.recompute``), ``scan_layers`` (the blocks as one
``ScannedStack``, ``models/scanned.py``; its caches stacked) and
``fused_loss_chunk`` (a training-mode forward returns ``(hidden,
lm_weight)`` and ``fused_loss_fn`` streams the LM head through
``F.fused_linear_cross_entropy``). Not yet: ``use_moe`` and the pipeline
class (ROADMAP.md).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..distributed.mesh import mesh_axis_size
from ..distributed.recompute import recompute
from ..distributed.sequence_parallel import ring_attention
from ..nn import Dropout, Embedding, Layer, LayerNorm, Linear
from ..nn import functional as F
from .generation import new_kv_caches, new_paged_kv_caches
from .scanned import ScannedStack, stacked_init_kinds

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny",
           "gpt_125m", "gpt_1p3b", "gpt_6p7b"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    ffn_mult: int = 4
    dropout: float = 0.0
    tie_embeddings: bool = True
    use_moe: bool = False
    moe_experts: int = 8
    initializer_range: float = 0.02
    recompute: bool = False
    recompute_policy: str = "full"   # read only under recompute
    scan_layers: bool = False
    fused_loss_chunk: int = 0


def gpt_tiny(**kw):
    return GPTConfig(vocab_size=256, hidden_size=64, num_layers=4,
                     num_heads=4, max_seq_len=128, **kw)


def gpt_125m(**kw):
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)


def gpt_1p3b(**kw):
    return GPTConfig(hidden_size=2048, num_layers=24, num_heads=16,
                     max_seq_len=2048, **kw)


def gpt_6p7b(**kw):
    return GPTConfig(hidden_size=4096, num_layers=32, num_heads=32,
                     max_seq_len=2048, **kw)


def _check_supported(cfg: GPTConfig):
    if cfg.use_moe:
        raise NotImplementedError(
            "GPTConfig.use_moe is not ported yet — see ROADMAP.md")


class GPTAttention(Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        h, nh = cfg.hidden_size, cfg.num_heads
        if h % nh:
            raise ValueError("hidden_size % num_heads != 0")
        self.num_heads = nh
        self.head_dim = h // nh
        self.qkv = Linear(h, 3 * h)
        self.out_proj = Linear(h, h)
        self.dropout = Dropout(cfg.dropout)

    def _qkv(self, x):
        B, S, _ = x.shape
        qkv = self.qkv(x)                           # [B, S, 3H]
        H = qkv.shape[-1] // 3
        shape = (B, S, self.num_heads, self.head_dim)
        return (qkv[..., :H].reshape(shape), qkv[..., H:2 * H].reshape(shape),
                qkv[..., 2 * H:].reshape(shape))

    def forward(self, x, cache=None, pos=None):
        B, S, H = x.shape
        q, k, v = self._qkv(x)
        if cache is not None:
            ctx, kc, vc = F.cached_attention(q, k, v, cache[0], cache[1], pos)
            return self.dropout(self.out_proj(ctx.reshape(B, S, H))), (kc, vc)
        if mesh_axis_size("sp") > 1:
            ctx = ring_attention(q, k, v, causal=True)
        else:
            ctx, _ = F.flash_attention(q, k, v, causal=True,
                                       training=self.training)
        return self.dropout(self.out_proj(ctx.reshape(B, S, H)))


class GPTMLP(Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.fc_in = Linear(h, cfg.ffn_mult * h)
        self.fc_out = Linear(cfg.ffn_mult * h, h)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x):
        return self.dropout(self.fc_out(F.gelu(self.fc_in(x))))


class GPTBlock(Layer):
    """Pre-LN transformer block."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.hidden_size)
        self.attn = GPTAttention(cfg)
        self.ln_2 = LayerNorm(cfg.hidden_size)
        self.mlp = GPTMLP(cfg)

    def forward(self, x, cache=None, pos=None):
        if cache is not None:
            att, cache = self.attn(self.ln_1(x), cache, pos)
            x = x + att
            return x + self.mlp(self.ln_2(x)), cache
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class GPTScannedBlocks(ScannedStack):
    """The GPT block stack as one ``ScannedStack`` (``cfg.scan_layers``);
    dropout is rejected, as in paddle_tpu."""

    def __init__(self, cfg: GPTConfig):
        ScannedStack.reject_dropout(cfg.dropout)
        super().__init__(lambda: GPTBlock(cfg), cfg.num_layers,
                         cfg.initializer_range, recompute=cfg.recompute,
                         recompute_policy=cfg.recompute_policy)


class GPTEmbeddings(Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = Embedding(cfg.max_seq_len,
                                             cfg.hidden_size)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, ids, pos=None):
        S = ids.shape[-1]
        max_len = self.position_embeddings.weight.shape[0]
        if S > max_len:
            raise ValueError(
                f"sequence length {S} exceeds max_seq_len {max_len}")
        positions = torch.arange(S, device=ids.device)
        if isinstance(pos, torch.Tensor) and pos.ndim == 1:
            # per-row offsets [B] (continuous-batching slots) -> [B, S]
            positions = positions[None, :] + pos.to(torch.int64)[:, None]
        elif pos is not None:
            positions = positions + int(pos)
        # an out-of-range position clamps, as the TPU gather does
        positions = positions.clamp(0, max_len - 1)
        x = self.word_embeddings(ids) + self.position_embeddings(positions)
        return self.dropout(x)


class GPTModel(Layer):
    """Decoder stack without head."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embeddings = GPTEmbeddings(cfg)
        if cfg.scan_layers:
            self.blocks = GPTScannedBlocks(cfg)
        else:
            self.blocks = []
            for i in range(cfg.num_layers):
                blk = GPTBlock(cfg)
                self.add_module(f"block_{i}", blk)
                self.blocks.append(blk)
        self.ln_f = LayerNorm(cfg.hidden_size)

    def forward(self, ids, caches=None, pos=None):
        if caches is not None:
            x = self.embeddings(ids, pos)
            if self.cfg.scan_layers:
                x, new_caches = self.blocks.forward_cached(x, caches, pos)
                return self.ln_f(x), new_caches
            new_caches = []
            for blk, c in zip(self.blocks, caches):
                x, c = blk(x, c, pos)
                new_caches.append(c)
            return self.ln_f(x), new_caches
        x = self.embeddings(ids)
        if self.cfg.scan_layers:
            return self.ln_f(self.blocks(x))
        if self.cfg.recompute and self.training:
            for blk in self.blocks:
                x = recompute(blk, x, policy=self.cfg.recompute_policy)
        else:
            for blk in self.blocks:
                x = blk(x)
        return self.ln_f(x)


class GPTForCausalLM(Layer):
    """GPT with the LM head tied to the word embedding (or an untied
    ``lm_head`` when ``cfg.tie_embeddings`` is False).

    ``device``: the card when omitted (raises without one); pass
    ``device="cpu"`` for the CPU. The model is built on the meta device
    and allocated on ``device``; then each parameter is drawn on the host
    by one CPU ``torch.Generator`` seeded by ``seed``, in name order, and
    copied over, so one seed gives the same weights on every device and
    the host holds one parameter at a time. The 2-D ``*.weight`` leaves
    (and a ``ScannedStack``'s leaves of per-layer rank >= 2) are drawn
    from ``N(0, initializer_range)``, the LayerNorm weights are ones and
    the biases zeros. The model is built in eval mode.
    """

    def __init__(self, cfg: GPTConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device("meta"):        # the draw below is the only one
            self.gpt = GPTModel(cfg)
            self.lm_head = (None if cfg.tie_embeddings else
                            Linear(cfg.hidden_size, cfg.vocab_size,
                                   bias_attr=False))
        self.to_empty(device=dev)
        kinds = stacked_init_kinds(self)
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for name, p in self.named_parameters():
                kind = kinds.get(id(p))
                if kind is None:
                    kind = ("normal" if p.ndim == 2 else "ones")  \
                        if name.endswith(".weight") else "zeros"
                if kind == "normal":
                    host = torch.empty(p.shape, dtype=torch.float32)
                    p.copy_(host.normal_(0.0, cfg.initializer_range,
                                         generator=gen))
                    del host
                else:
                    p.fill_(1.0 if kind == "ones" else 0.0)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.gpt.ln_f.weight.device

    def forward(self, ids, caches=None, pos=None):
        """``forward(ids)`` -> logits [B, S, V] (no-cache), or, in
        training mode with ``fused_loss_chunk``, ``(hidden [B, S, H],
        lm_weight)`` for ``fused_loss_fn`` (the logits never exist
        whole); ``forward(ids, caches, pos)`` -> (logits, caches), the
        caches written in place (see ``cached_attention``)."""
        if caches is not None:
            x, caches = self.gpt(ids, caches, pos)
            return self._logits(x), caches
        x = self.gpt(ids)
        if self.cfg.fused_loss_chunk and self.training:
            return x, self._lm_weight()
        return self._logits(x)

    def _lm_weight(self):
        """The LM head's weight: the tied ``[V, H]`` embedding, or the
        untied head's ``[H, V]``."""
        if self.lm_head is None:
            return self.gpt.embeddings.word_embeddings.weight
        return self.lm_head.weight

    def _logits(self, x):
        if self.lm_head is None:
            return x @ self.gpt.embeddings.word_embeddings.weight.t()
        return self.lm_head(x)

    @staticmethod
    def loss_fn(logits, labels):
        """Next-token prediction: logits at position i predict labels[i+1]
        (callers pass labels=input_ids). paddle_tpu slices the logits to
        ``[:, :-1]``; here every row goes to ``cross_entropy`` and the last
        position's label is the ignore index (-100) instead, which gives
        the same mean over the same B*(S-1) tokens without copying the
        [B, S-1, V] slice (the logits stay contiguous for the fused CE
        kernel)."""
        B, V = labels.shape[0], logits.shape[-1]
        shifted = torch.cat([labels[:, 1:], labels.new_full((B, 1), -100)],
                            dim=1)
        return F.cross_entropy(logits.reshape(-1, V), shifted.reshape(-1))

    @staticmethod
    def fused_loss_fn(outputs, labels, chunk_size=512):
        """``loss_fn``'s counterpart for ``fused_loss_chunk`` models:
        ``outputs`` is ``(hidden, lm_weight)`` from a training-mode
        forward, and the LM head streams through
        ``F.fused_linear_cross_entropy`` in chunks of ``chunk_size``
        tokens. The shift is ``loss_fn``'s: the last position's label is
        the ignore index, so ``hidden`` is not copied. Plain logits (an
        eval-mode forward) fall through to ``loss_fn``."""
        if not isinstance(outputs, tuple):
            return GPTForCausalLM.loss_fn(outputs, labels)
        hidden, w = outputs
        B = labels.shape[0]
        shifted = torch.cat([labels[:, 1:], labels.new_full((B, 1), -100)],
                            dim=1)
        return F.fused_linear_cross_entropy(hidden, w, shifted,
                                            chunk_size=chunk_size)

    def make_loss_fn(self):
        """The loss this config trains with: ``fused_loss_fn`` bound to
        ``cfg.fused_loss_chunk`` when it is set, else ``loss_fn``."""
        if self.cfg.fused_loss_chunk:
            return functools.partial(self.fused_loss_fn,
                                     chunk_size=self.cfg.fused_loss_chunk)
        return self.loss_fn

    def new_cache(self, batch_size: int, max_len: int, dtype="bfloat16"):
        """Per-layer (k, v) caches [B, max_len, nh, hd] on the model's
        device, or one stacked (k_stack, v_stack) pair for a
        ``scan_layers`` model (dtype "int8" -> the quantised dict form)."""
        cfg = self.cfg
        return new_kv_caches(cfg.num_layers, batch_size, max_len,
                             cfg.num_heads, cfg.hidden_size // cfg.num_heads,
                             dtype, cfg.scan_layers, self.device)

    def new_paged_cache(self, num_pages: int, page_size: int,
                        dtype="bfloat16"):
        """Per-layer (k, v) page pools [num_pages, page_size, nh, hd] for
        the paged serving engine on the model's device (one stacked pair
        for a ``scan_layers`` model); block tables are engine state, not
        part of them."""
        cfg = self.cfg
        return new_paged_kv_caches(cfg.num_layers, num_pages, page_size,
                                   cfg.num_heads,
                                   cfg.hidden_size // cfg.num_heads, dtype,
                                   cfg.scan_layers, self.device)

    def generate(self, input_ids, max_new_tokens=32, **kw):
        from .generation import generate
        return generate(self, input_ids, max_new_tokens, **kw)
