"""Blockwise flash attention with LSE residuals (B5): attention of q
against one k/v block at global offsets, returning ``(out, lse)``, and its
backward against global residuals: the building block of ring and Ulysses
sequence parallelism (``distributed/sequence_parallel.py``).

Port of paddle_tpu/kernels/flash_block.py (``flash_block_attention``
``:348``, ``flash_block_attention_bwd`` ``:386``, ``flash_attention_lse``
``:401``, whose Pallas kernels are ``_fwd`` ``:114`` and ``_bwd`` ``:244``).
On the TPU these are kernels of their own because the library flash kernel
hides the LSE. On the card B1's kernels already return it and take runtime
offsets, so B5 runs B1's device code, on B1's paths (``_tc_path``: on
the tensor cores bf16 with D 64 or 128, ``csrc/flash_attention_sm90.cu``,
and f32 with D 64 as 3xTF32, ``csrc/flash_attention_sm90_f32.cu``; every
other D on the SIMT kernels, ``csrc/flash_attention.cu``):

- the forward is B1's forward entry (``flash_fwd_tc_launch``,
  ``flash_fwd_tf32_launch`` or ``flash_fwd_launch``); a block wholly in the
  causal future loads nothing and gives ``out = 0``, ``lse = -inf`` (the
  merge identity);
- the backward is ``flash_block_bwd_tc_launch``,
  ``flash_block_bwd_tf32_launch`` or ``flash_block_bwd_launch``: B1's two
  passes (dQ, then dK/dV) against a ``delta`` the caller gives, which the
  dQ pass reads instead of computing ``rowsum(dO * O)`` and writing it (on
  the tensor-core path a block no query sees takes one launch that writes
  zero grads). A ring hoists one ``delta`` per layer
  out of its sp block steps; one block's own backward folds its lse
  cotangent into it (``compute_delta``). The plain versions are B1's
  (f32 products, as paddle_tpu's ``_fwd_kernel`` and ``_bwd`` take
  them).

Launch counters are B5's own (``flash_block_fwd.launches``,
``flash_block_bwd.launches``, one per wrapper call, each also counted in
``.tc_launches`` or ``.simt_launches`` by path; the backward issues two
device launches), apart from B1's, so a run shows which path it took.
``compute_delta`` and ``merge_lse_blocks`` are XLA code in paddle_tpu and
plain PyTorch here. Layout ``(B, H, S, D)``; ``lse`` and ``delta`` are
``[B, H, Sq]`` f32.
"""
from __future__ import annotations

import torch

from . import check_launch, common_device, ptr, require_contiguous, stream_ptr
from . import flash_attention as _fa

__all__ = ["flash_block_attention", "flash_block_attention_bwd",
           "flash_attention_lse", "compute_delta", "merge_lse_blocks",
           "flash_block_fwd", "flash_block_bwd", "flash_block_fwd_plain",
           "flash_block_bwd_plain"]

_NEG_INF = float("-inf")


def flash_block_fwd_plain(q, k, v, q_off, k_off, causal, sm_scale):
    """Plain PyTorch forward: B1's plain forward at these offsets. Returns
    (out at q's dtype, lse [B, H, Sq] at the accumulation dtype)."""
    return _fa.flash_attn_fwd_plain(q, k, v, causal, sm_scale, int(q_off),
                                    int(k_off))


def flash_block_bwd_plain(q, k, v, q_off, k_off, lse, do, delta, causal,
                          sm_scale):
    """Plain PyTorch block backward against given (lse, delta): ``p =
    exp(s - lse)``, ``dS = p (dO V^T - delta) scale``. Returns (dq, dk,
    dv) at the inputs' dtypes."""
    return _fa._grads(q, k, v, lse, do, delta, causal, sm_scale, int(q_off),
                      int(k_off))


def flash_block_fwd(q, k, v, q_off, k_off, causal, sm_scale):
    """Block forward. q [B, H, Sq, D], k/v [B, H, Sk, D], f32 or bf16 (one
    dtype), D <= 128, contiguous, one device; ``q_off``/``k_off`` the
    global positions of q[0]/k[0]. On CUDA tensors launches B5's forward on
    the path ``_tc_path`` picks (counted in ``flash_block_fwd.launches``
    and ``.tc_launches`` or ``.simt_launches``); on CPU tensors runs
    ``flash_block_fwd_plain``. Returns (out at q's dtype, lse f32)."""
    dev = common_device("flash_block_fwd", q, k, v)
    if dev.type == "cpu":
        return flash_block_fwd_plain(q, k, v, q_off, k_off, causal, sm_scale)
    out, lse, tc = _fa._launch_fwd("flash_block_fwd", q, k, v, causal,
                                   sm_scale, q_off, k_off, dev)
    _fa._count(flash_block_fwd, tc)
    return out, lse


def flash_block_bwd(q, k, v, q_off, k_off, lse, do, delta, causal,
                    sm_scale):
    """Block backward against global residuals: q/k/v as
    ``flash_block_fwd``, do like q, lse and delta [B, H, Sq] f32 (read
    only). On CUDA tensors launches B5's two backward kernels on the path
    ``_tc_path`` picks (counted once in ``flash_block_bwd.launches`` and
    in ``.tc_launches`` or ``.simt_launches``); on CPU tensors runs
    ``flash_block_bwd_plain``. Returns (dq, dk, dv)."""
    dev = common_device("flash_block_bwd", q, k, v, lse, do, delta)
    if dev.type == "cpu":
        return flash_block_bwd_plain(q, k, v, q_off, k_off, lse, do, delta,
                                     causal, sm_scale)
    BH, Sq, Sk, D = _fa._check("flash_block_bwd", q, k, v)
    rows = tuple(q.shape[:3])
    if (do.shape != q.shape or do.dtype != q.dtype
            or any(t.dtype != torch.float32 or tuple(t.shape) != rows
                   for t in (lse, delta))):
        raise ValueError(
            f"flash_block_bwd: do {do.dtype}{tuple(do.shape)}, lse "
            f"{lse.dtype}{tuple(lse.shape)}, delta {delta.dtype}"
            f"{tuple(delta.shape)} for q {q.dtype}{tuple(q.shape)}")
    require_contiguous("flash_block_bwd", q=q, k=k, v=v, lse=lse, do=do,
                       delta=delta)
    tc = _fa._tc_path(q.dtype, D)
    if tc:
        _fa._require_tma_aligned("flash_block_bwd", q=q, k=k, v=v, do=do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(dev):
        rc = _fa._entry(tc, q.dtype, "flash_block_bwd")(
            ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dq),
            ptr(dk), ptr(dv),
            *_fa._geo(BH, Sq, Sk, D, causal, q_off, k_off, sm_scale,
                      q.dtype), stream_ptr(dev))
    check_launch("flash_block_bwd", rc)
    _fa._count(flash_block_bwd, tc)
    return dq, dk, dv


for _w in (flash_block_fwd, flash_block_bwd):
    _w.launches = _w.tc_launches = _w.simt_launches = 0


def compute_delta(out, do, dlse=None):
    """FlashAttention-2 delta term: ``rowsum(dO * O)`` in f32, minus any
    lse cotangent (d(lse)/ds = p, so dlse folds into delta)."""
    delta = (do.float() * out.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta


def merge_lse_blocks(out_a, lse_a, out_b, lse_b):
    """Exact merge of two attention partials over disjoint key sets.
    out_*: [..., S, D] f32; lse_*: [..., S] f32. Identity: (0, -inf)."""
    lse = torch.logaddexp(lse_a, lse_b)
    lse_safe = torch.where(lse == _NEG_INF, 0.0, lse)
    wa = torch.exp(lse_a - lse_safe)[..., None]
    wb = torch.exp(lse_b - lse_safe)[..., None]
    return out_a * wa + out_b * wb, lse


class _FlashBlock(torch.autograd.Function):
    """(out, lse) of one block; the backward folds the lse cotangent into
    delta and runs B5's backward (paddle_tpu's ``_fba_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, q_off, k_off, causal, sm_scale):
        q, k, v = (t.contiguous() for t in (q, k, v))
        out, lse = flash_block_fwd(q, k, v, q_off, k_off, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (int(q_off), int(k_off), causal, sm_scale)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        q_off, k_off, causal, sm_scale = ctx.args
        delta = compute_delta(out, do, dlse)
        dq, dk, dv = flash_block_bwd(q, k, v, q_off, k_off, lse,
                                     do.contiguous(), delta.contiguous(),
                                     causal, sm_scale)
        return dq, dk, dv, None, None, None, None


def flash_block_attention(q, k, v, q_off, k_off, causal=False,
                          sm_scale=1.0):
    """Attention of q [B, H, Sq, D] against one k/v block [B, H, Sk, D];
    ``q_off``/``k_off`` are the global positions of q[0]/k[0] (ints).
    Returns (out [B, H, Sq, D] at q's dtype, lse [B, H, Sq] f32); a row
    with every key masked gives out 0, lse -inf. Differentiable in q, k, v
    through both outputs."""
    return _FlashBlock.apply(q, k, v, int(q_off), int(k_off), bool(causal),
                             float(sm_scale))


def flash_block_attention_bwd(q, k, v, q_off, k_off, out, lse, do,
                              causal=False, sm_scale=1.0, delta=None):
    """Per-block backward against GLOBAL (out, lse, do) residuals, the
    building block of the ring backward. Pass ``delta =
    compute_delta(out, do)`` when calling it per block in a loop (``out``
    is then not read). Returns (dq, dk, dv) for this q/kv-block pair."""
    if delta is None:
        delta = compute_delta(out, do)
    return flash_block_bwd(q.contiguous(), k.contiguous(), v.contiguous(),
                           q_off, k_off, lse.contiguous(), do.contiguous(),
                           delta.contiguous(), causal, sm_scale)


def flash_attention_lse(q, k, v, causal=False, sm_scale=None):
    """Full self-attention through the block kernel ((B, H, S, D) layout,
    offsets 0/0). Returns (out, lse)."""
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    return flash_block_attention(q, k, v, 0, 0, causal, sm_scale)
