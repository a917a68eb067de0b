"""LLaMA decoder family (port of paddle_tpu/models/llama.py): serving and
training.

Parameter names and layouts match paddle_tpu's, so weights carry across by
name with no transpose (``convert.load_paddle_tpu_params``): every Linear
weight is ``[in, out]`` with no bias (``llama.block_{i}.self_attn.{q,k,v,
o}_proj.weight``, ``llama.block_{i}.mlp.{gate,up,down}_proj.weight``), the
norms are ``RMSNorm`` weights (``llama.block_{i}.{input,post_attention}_
layernorm.weight``, ``llama.norm.weight``), and the LM head
``lm_head.weight`` is untied from ``llama.embed_tokens.weight``.

GQA: ``num_kv_heads`` may be below ``num_heads`` (any divisor). The caches
keep the kv heads and the cached path attends through ``cached_attention``
(the B4 kernel for the S=1 slot decode, at any group count); the
no-cache forward repeats k and v to the query heads and runs the flash
kernels (B1) or, when the mesh has an ``sp`` axis above 1,
``ring_attention`` (B5). RoPE uses the interleaved-pairs convention in f32.

The training memory features are GPT's: ``recompute`` /
``recompute_policy``, ``scan_layers`` (``LlamaScannedBlocks``, stacked
caches) and ``fused_loss_chunk`` (a training-mode forward returns
``(hidden, lm_head.weight)``, the ``[H, V]`` weight, for
``fused_loss_fn``). Not yet: the pipeline class
``LlamaPipelineForCausalLM`` (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..distributed.mesh import mesh_axis_size
from ..distributed.recompute import recompute
from ..distributed.sequence_parallel import ring_attention
from ..nn import Embedding, Layer, Linear, RMSNorm
from ..nn import functional as F
from .generation import new_kv_caches, new_paged_kv_caches
from .gpt import GPTForCausalLM
from .scanned import ScannedStack, stacked_init_kinds

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama_tiny",
           "llama_7b", "llama_13b"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # None -> MHA
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    initializer_range: float = 0.02
    recompute: bool = False
    recompute_policy: str = "full"   # read only under recompute
    scan_layers: bool = False
    fused_loss_chunk: int = 0

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads


def llama_tiny(**kw):
    return LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=176,
                       num_layers=4, num_heads=4, num_kv_heads=2,
                       max_seq_len=128, **kw)


def llama_7b(**kw):
    return LlamaConfig(hidden_size=4096, intermediate_size=11008,
                       num_layers=32, num_heads=32, **kw)


def llama_13b(**kw):
    return LlamaConfig(hidden_size=5120, intermediate_size=13824,
                       num_layers=40, num_heads=40, **kw)


def _rope(q, k, theta: float, offset=None):
    """Rotary position embedding of q/k ``[B, S, H, D]``, interleaved
    pairs ``(x0, x1) -> (x0 c - x1 s, x1 c + x0 s)`` with ``freqs = theta
    ** (-arange(D/2) / (D/2))``, computed in f32 and cast back. ``offset``
    shifts the positions: an int, or a ``[B]`` tensor of per-row offsets
    (continuous-batching slots)."""
    S, D = q.shape[1], q.shape[-1]
    half = D // 2
    dev = q.device
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=dev)
                      / half)
    pos = torch.arange(S, dtype=torch.float32, device=dev)
    if isinstance(offset, torch.Tensor) and offset.ndim == 1:
        pos = pos[None, :] + offset.float()[:, None]          # [B, S]
    elif offset is not None:
        pos = pos + float(offset)
    ang = pos[..., None] * freqs               # [S, half] or [B, S, half]
    cos, sin = ang.cos(), ang.sin()
    if ang.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]

    def rot(x):
        xf = x.float()
        x0, x1 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1)
        return out.reshape(x.shape).to(x.dtype)

    return rot(q), rot(k)


class LlamaAttention(Layer):
    """Causal self-attention with RoPE and GQA."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        h, nh, nkv = cfg.hidden_size, cfg.num_heads, cfg.kv_heads
        if h % nh:
            raise ValueError("hidden_size % num_heads != 0")
        if nh % nkv:
            raise ValueError("num_heads % num_kv_heads != 0")
        self.num_heads = nh
        self.kv_heads = nkv
        self.head_dim = h // nh
        self.theta = cfg.rope_theta
        self.q_proj = Linear(h, nh * self.head_dim, bias_attr=False)
        self.k_proj = Linear(h, nkv * self.head_dim, bias_attr=False)
        self.v_proj = Linear(h, nkv * self.head_dim, bias_attr=False)
        self.o_proj = Linear(nh * self.head_dim, h, bias_attr=False)

    def forward(self, x, cache=None, pos=None):
        B, S, _ = x.shape
        hd, nh, nkv = self.head_dim, self.num_heads, self.kv_heads
        q = self.q_proj(x).reshape(B, S, nh, hd)
        k = self.k_proj(x).reshape(B, S, nkv, hd)
        v = self.v_proj(x).reshape(B, S, nkv, hd)
        q, k = _rope(q, k, self.theta, offset=pos)
        if cache is not None:
            # the caches keep nkv heads; cached_attention shares them
            ctx, kc, vc = F.cached_attention(q, k, v, cache[0], cache[1],
                                             pos)
            return self.o_proj(ctx.reshape(B, S, nh * hd)), (kc, vc)
        if nkv != nh:
            k = k.repeat_interleave(nh // nkv, dim=2)
            v = v.repeat_interleave(nh // nkv, dim=2)
        if mesh_axis_size("sp") > 1:
            ctx = ring_attention(q, k, v, causal=True)
        else:
            ctx, _ = F.flash_attention(q, k, v, causal=True,
                                       training=self.training)
        return self.o_proj(ctx.reshape(B, S, nh * hd))


class LlamaMLP(Layer):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Linear(h, m, bias_attr=False)
        self.up_proj = Linear(h, m, bias_attr=False)
        self.down_proj = Linear(m, h, bias_attr=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(Layer):
    """Pre-RMSNorm block."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, cache=None, pos=None):
        if cache is not None:
            att, cache = self.self_attn(self.input_layernorm(x), cache, pos)
            x = x + att
            x = x + self.mlp(self.post_attention_layernorm(x))
            return x, cache
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaScannedBlocks(ScannedStack):
    """The Llama block stack as one ``ScannedStack``
    (``cfg.scan_layers``)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__(lambda: LlamaBlock(cfg), cfg.num_layers,
                         cfg.initializer_range, recompute=cfg.recompute,
                         recompute_policy=cfg.recompute_policy)


class LlamaModel(Layer):
    """Decoder stack without head."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size)
        if cfg.scan_layers:
            self.blocks = LlamaScannedBlocks(cfg)
        else:
            self.blocks = []
            for i in range(cfg.num_layers):
                blk = LlamaBlock(cfg)
                self.add_module(f"block_{i}", blk)
                self.blocks.append(blk)
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps)

    def forward(self, ids, caches=None, pos=None):
        if ids.shape[-1] > self.cfg.max_seq_len:
            raise ValueError(
                f"sequence length {ids.shape[-1]} exceeds max_seq_len "
                f"{self.cfg.max_seq_len}")
        x = self.embed_tokens(ids)
        if caches is not None:
            if self.cfg.scan_layers:
                x, new_caches = self.blocks.forward_cached(x, caches, pos)
                return self.norm(x), new_caches
            new_caches = []
            for blk, c in zip(self.blocks, caches):
                x, c = blk(x, c, pos)
                new_caches.append(c)
            return self.norm(x), new_caches
        if self.cfg.scan_layers:
            return self.norm(self.blocks(x))
        if self.cfg.recompute and self.training:
            for blk in self.blocks:
                x = recompute(blk, x, policy=self.cfg.recompute_policy)
        else:
            for blk in self.blocks:
                x = blk(x)
        return self.norm(x)


class LlamaForCausalLM(Layer):
    """Llama with an untied LM head.

    ``device``: the card when omitted (raises without one); pass
    ``device="cpu"`` for the CPU. The parameters are allocated on that
    device and drawn there, one after another, by a ``torch.Generator`` of
    that device seeded by ``seed`` (a 13 B model never passes through host
    memory): 2-D weights from ``N(0, initializer_range)``, the RMSNorm
    weights ones, a ``ScannedStack``'s leaves by its rule (per-layer rank
    >= 2 drawn, the stacked RMSNorm weights ones). CPU and CUDA generators draw different numbers, so one
    seed gives different weights on the two device types; to compare
    them, copy one model's weights into the other
    (``convert.load_paddle_tpu_params``). The model is built in eval
    mode.
    """

    def __init__(self, cfg: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device("meta"):
            self.llama = LlamaModel(cfg)
            self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias_attr=False)
        self.to_empty(device=dev)
        kinds = stacked_init_kinds(self)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        with torch.no_grad():
            for p in self.parameters():
                kind = kinds.get(id(p), "normal" if p.ndim == 2 else "ones")
                if kind == "normal":
                    p.normal_(0.0, cfg.initializer_range, generator=gen)
                else:
                    p.fill_(1.0 if kind == "ones" else 0.0)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.llama.norm.weight.device

    def forward(self, ids, caches=None, pos=None):
        """``forward(ids)`` -> logits [B, S, V] (no-cache), or, in
        training mode with ``fused_loss_chunk``, ``(hidden, lm_head.weight
        [H, V])`` for ``fused_loss_fn``; ``forward(ids, caches, pos)`` ->
        (logits, caches), the caches written in place (see
        ``cached_attention``)."""
        if caches is not None:
            x, caches = self.llama(ids, caches, pos)
            return self.lm_head(x), caches
        x = self.llama(ids)
        if self.cfg.fused_loss_chunk and self.training:
            return x, self.lm_head.weight
        return self.lm_head(x)

    # the next-token shift and the fused cross-entropy kernels, as GPT's
    loss_fn = staticmethod(GPTForCausalLM.loss_fn)
    fused_loss_fn = staticmethod(GPTForCausalLM.fused_loss_fn)
    make_loss_fn = GPTForCausalLM.make_loss_fn

    def new_cache(self, batch_size: int, max_len: int, dtype="bfloat16"):
        """Per-layer (k, v) caches [B, max_len, n_kv_heads, hd] on the
        model's device, stacked for ``scan_layers`` (dtype "int8" -> the
        quantised dict form)."""
        cfg = self.cfg
        return new_kv_caches(cfg.num_layers, batch_size, max_len,
                             cfg.kv_heads, cfg.hidden_size // cfg.num_heads,
                             dtype, cfg.scan_layers, self.device)

    def new_paged_cache(self, num_pages: int, page_size: int,
                        dtype="bfloat16"):
        """Per-layer (k, v) page pools [num_pages, page_size, n_kv_heads,
        hd] for the paged serving engine on the model's device."""
        cfg = self.cfg
        return new_paged_kv_caches(cfg.num_layers, num_pages, page_size,
                                   cfg.kv_heads,
                                   cfg.hidden_size // cfg.num_heads, dtype,
                                   cfg.scan_layers, self.device)

    def generate(self, input_ids, max_new_tokens=32, **kw):
        from .generation import generate
        return generate(self, input_ids, max_new_tokens, **kw)
