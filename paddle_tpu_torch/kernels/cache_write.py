"""S=1 slot KV-cache write: ``cache[b, pos[b]] = rows[b, 0]`` in one launch.

Port of paddle_tpu/kernels/cache_write.py:fused_slot_write (TPU Pallas,
slot form; the paged form ``fused_paged_write`` is not ported yet — see
ROADMAP.md). The CUDA kernel is ``csrc/cache_write.cu``: one thread per
element of the new rows, writing only those rows, so a launch is bound by
launch latency, not bytes (see the source note there).

Unlike the JAX function, which returns a new cache aliased to the old,
this one updates ``cache`` IN PLACE and returns it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import (_build, check_launch, common_device, ptr, require_contiguous,
               stream_ptr)

__all__ = ["fused_slot_write", "fused_slot_write_plain"]

_DTYPES = (torch.int8, torch.float32, torch.bfloat16)
_SIGNATURES = {"slot_write_launch": (ctypes.c_int, [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])}


def fused_slot_write_plain(cache, rows, pos):
    """Plain PyTorch version: rows whose position lies in [0, L) land at
    ``cache[b, pos[b]]`` (cast to the cache dtype); others write nothing."""
    L = cache.shape[1]
    pos = pos.to(torch.int64)
    hit = ((pos >= 0) & (pos < L)).nonzero()[:, 0]
    cache[hit, pos[hit]] = rows[hit, 0].to(cache.dtype)
    return cache


def fused_slot_write(cache, rows, pos):
    """One-launch S=1 slot write.

    cache [B, L, ...] int8 / f32 / bf16 (the [B, L, nkv, hd] data array or
    the [B, L, nkv] int8-cache scale plane); rows [B, 1, ...] of the same
    dtype; pos [B] int32; all contiguous, all on one device. On CUDA
    tensors launches the kernel (counted in ``fused_slot_write.launches``);
    on CPU tensors runs ``fused_slot_write_plain``. Returns ``cache``,
    updated in place.
    """
    dev = common_device("fused_slot_write", cache, rows, pos)
    if dev.type == "cpu":
        return fused_slot_write_plain(cache, rows, pos)
    B, L = cache.shape[0], cache.shape[1]
    inner = tuple(cache.shape[2:])
    if tuple(rows.shape) != (B, 1) + inner or tuple(pos.shape) != (B,):
        raise ValueError(f"fused_slot_write: shapes cache{tuple(cache.shape)} "
                         f"rows{tuple(rows.shape)} pos{tuple(pos.shape)}")
    if (cache.dtype not in _DTYPES or rows.dtype != cache.dtype
            or pos.dtype != torch.int32):
        raise ValueError(f"fused_slot_write: dtypes cache {cache.dtype}, rows "
                         f"{rows.dtype}, pos {pos.dtype} (cache one of "
                         f"{_DTYPES}, rows the same, pos int32)")
    require_contiguous("fused_slot_write", cache=cache, rows=rows, pos=pos)
    lib = _build.load("cache_write", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.slot_write_launch(ptr(cache), ptr(rows), ptr(pos), B, L,
                                   math.prod(inner), cache.element_size(),
                                   stream_ptr(dev))
    check_launch("fused_slot_write", rc)
    fused_slot_write.launches += 1
    return cache


fused_slot_write.launches = 0
