"""Mega-kernel decode inner step: cache read -> attention -> cache write for
one layer in one launch.

Port of paddle_tpu/kernels/mega_decode.py:mega_decode_step (TPU Pallas;
math in ``_attend``). The CUDA kernel is ``csrc/mega_decode.cu``: one block
per (batch row, kv head) walks the OLD cache under a strict ``l < pos[b]``
mask with an online softmax in f32, merges the incoming k/v row at its
incoming precision, writes ctx, then writes the new row at ``pos[b]`` when
``0 <= pos[b] < L``. It is bound by the cache bytes it reads (see the
source note there).

Unlike the JAX function, which returns new caches aliased to the old,
this one updates ``kc`` and ``vc`` IN PLACE and returns them.
"""
from __future__ import annotations

import ctypes

import torch

from . import (_build, check_launch, common_device, ptr, require_contiguous,
               stream_ptr)

__all__ = ["mega_decode_step", "mega_decode_step_plain"]

_NEG_INF = -1e30
_GROUPS = (1, 2, 4, 8)
_MAX_HEAD_DIM = 256
_SIGNATURES = {"mega_decode_launch": (ctypes.c_int, [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float, ctypes.c_void_p])}


def _scale(hd: int) -> float:
    return 1.0 / float(hd) ** 0.5


def mega_decode_step_plain(q, k, v, kc, vc, pos):
    """Plain PyTorch version of the kernel (same math as the JAX
    ``_attend``): q [B,1,nh,hd]; k/v [B,1,nkv,hd]; kc/vc [B,L,nkv,hd]
    f32/bf16; pos [B] int. Returns (ctx [B,1,nh,hd] at q's dtype, kc, vc)
    with the caches written in place."""
    B, L, nkv, hd = kc.shape
    nh = q.shape[2]
    g = nh // nkv
    scale = _scale(hd)
    pos = pos.to(torch.int64)
    qf = q.float().reshape(B, nkv, g, hd)
    kf = k.float()[:, 0]                                   # [B,nkv,hd]
    vf = v.float()[:, 0]
    l_ids = torch.arange(L, device=kc.device)[None, :]
    strict = l_ids < pos[:, None]                          # [B, L]
    logits = (kc.float()[:, :, :, None, :] * qf[:, None]).sum(-1) * scale
    logits = torch.where(strict[:, :, None, None], logits,
                         torch.full_like(logits, _NEG_INF))  # [B,L,nkv,g]
    logit_new = (kf[:, :, None, :] * qf).sum(-1) * scale   # [B,nkv,g]
    m = torch.maximum(logits.amax(1), logit_new)
    p = torch.exp(logits - m[:, None])
    p_new = torch.exp(logit_new - m)
    den = p.sum(1) + p_new
    ctx = (p[..., None] * vc.float()[:, :, :, None, :]).sum(1)
    ctx = ctx + p_new[..., None] * vf[:, :, None, :]
    ctx = (ctx / den[..., None]).reshape(B, 1, nh, hd).to(q.dtype)
    rows = ((pos >= 0) & (pos < L)).nonzero()[:, 0]
    kc[rows, pos[rows]] = k[rows, 0].to(kc.dtype)
    vc[rows, pos[rows]] = v[rows, 0].to(vc.dtype)
    return ctx, kc, vc


def mega_decode_step(q, k, v, kc, vc, pos):
    """One-launch S=1 decode layer step; see the module docstring.

    q [B,1,nh,hd] and k/v [B,1,nkv,hd] f32 or bf16 (one dtype); kc/vc
    [B,L,nkv,hd] f32 or bf16 (one dtype); pos [B] int32; nh/nkv in
    (1, 2, 4, 8); hd <= 256. All contiguous, all on one device. On CUDA
    tensors launches the kernel (counted in ``mega_decode_step.launches``);
    on CPU tensors runs ``mega_decode_step_plain``. Returns
    (ctx [B,1,nh,hd] at q's dtype, kc, vc) with kc/vc updated in place.
    """
    dev = common_device("mega_decode_step", q, k, v, kc, vc, pos)
    if dev.type == "cpu":
        return mega_decode_step_plain(q, k, v, kc, vc, pos)
    B, L, nkv, hd = kc.shape
    nh = q.shape[2]
    if (tuple(q.shape) != (B, 1, nh, hd) or tuple(k.shape) != (B, 1, nkv, hd)
            or tuple(v.shape) != (B, 1, nkv, hd) or vc.shape != kc.shape
            or tuple(pos.shape) != (B,)):
        raise ValueError(
            f"mega_decode_step: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} kc{tuple(kc.shape)} vc{tuple(vc.shape)} "
            f"pos{tuple(pos.shape)}")
    if nh % nkv or nh // nkv not in _GROUPS or hd > _MAX_HEAD_DIM:
        raise ValueError(f"mega_decode_step: nh={nh} nkv={nkv} hd={hd} "
                         f"(need nh/nkv in {_GROUPS}, hd <= {_MAX_HEAD_DIM})")
    floats = (torch.float32, torch.bfloat16)
    if (q.dtype not in floats or k.dtype != q.dtype or v.dtype != q.dtype
            or kc.dtype not in floats or vc.dtype != kc.dtype
            or pos.dtype != torch.int32):
        raise ValueError(
            f"mega_decode_step: dtypes q/k/v {q.dtype}/{k.dtype}/{v.dtype}, "
            f"kc/vc {kc.dtype}/{vc.dtype}, pos {pos.dtype}")
    require_contiguous("mega_decode_step", q=q, k=k, v=v, kc=kc, vc=vc,
                       pos=pos)
    lib = _build.load("mega_decode", _SIGNATURES)
    ctx = torch.empty_like(q)
    with torch.cuda.device(dev):
        rc = lib.mega_decode_launch(
            ptr(q), ptr(k), ptr(v), ptr(kc), ptr(vc), ptr(pos), ptr(ctx),
            B, L, nkv, nh // nkv, hd, int(q.dtype == torch.bfloat16),
            int(kc.dtype == torch.bfloat16), _scale(hd), stream_ptr(dev))
    check_launch("mega_decode_step", rc)
    mega_decode_step.launches += 1
    return ctx, kc, vc


mega_decode_step.launches = 0
