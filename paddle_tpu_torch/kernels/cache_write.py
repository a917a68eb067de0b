"""KV-cache writes in one launch: the slot form ``cache[b, pos[b]] =
rows[b, 0]`` and the paged form ``pages[phys[i], off[i]] = rows[i]``.

Port of paddle_tpu/kernels/cache_write.py (TPU Pallas): ``fused_slot_write``
(B3 slot) and ``fused_paged_write`` (B3 paged). The CUDA kernels are in
``csrc/cache_write.cu``: one thread per element of the new rows, writing
only those rows, so a launch is bound by launch latency, not bytes (see
the source note there).

Unlike the JAX functions, which return a new cache aliased to the old,
these update ``cache`` / ``pages`` IN PLACE and return it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import (_build, check_launch, common_device, ptr, require_contiguous,
               stream_ptr)

__all__ = ["fused_slot_write", "fused_slot_write_plain",
           "fused_paged_write", "fused_paged_write_plain"]

_DTYPES = (torch.int8, torch.float32, torch.bfloat16)
_SIGNATURES = {"slot_write_launch": (ctypes.c_int, [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]),
    "paged_write_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])}


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


def fused_paged_write_plain(pages, rows_flat, phys, off, valid):
    """Plain PyTorch version: row i lands at ``pages[phys[i], off[i]]``
    where ``valid[i] != 0``, ``0 <= phys[i] < NP`` and ``0 <= off[i] <
    PS``; other rows write nothing. Where valid rows collide, the last one
    wins, as in the TPU kernel's sequential loop."""
    NP, PS = pages.shape[0], pages.shape[1]
    phys, off = phys.to(torch.int64), off.to(torch.int64)
    hit = ((valid != 0) & (phys >= 0) & (phys < NP) & (off >= 0)
           & (off < PS)).nonzero()[:, 0]
    key = phys[hit] * PS + off[hit]
    order = torch.arange(hit.shape[0], device=pages.device)
    last = torch.full((NP * PS,), -1, dtype=torch.int64, device=pages.device)
    last.scatter_reduce_(0, key, order, "amax")
    hit = hit[last[key] == order]
    pages[phys[hit], off[hit]] = rows_flat[hit].to(pages.dtype)
    return pages


def fused_paged_write(pages, rows_flat, phys, off, valid):
    """One-launch paged-pool write.

    pages [NP, PS, ...] bf16 / f32 / int8 (a pool half, or the f32 [NP,
    PS, nkv] scale plane of an int8 pool); rows_flat [n, ...] of the same
    dtype (pre-quantised for int8 pools); phys, off, valid [n] int32 (the
    physical page, the in-page offset, and the write gate with live, wlen
    and table bounds folded in by the caller); all contiguous, all on one
    device. Valid rows must target distinct (page, offset) pairs — the
    caller's copy-on-write invariant; where they collide the plain version
    keeps the last and the kernel an unspecified one. On CUDA tensors
    launches the kernel (counted in ``fused_paged_write.launches``); on CPU
    tensors runs ``fused_paged_write_plain``. Returns ``pages``, updated
    in place.
    """
    dev = common_device("fused_paged_write", pages, rows_flat, phys, off,
                        valid)
    if dev.type == "cpu":
        return fused_paged_write_plain(pages, rows_flat, phys, off, valid)
    NP, PS = pages.shape[0], pages.shape[1]
    inner = tuple(pages.shape[2:])
    n = rows_flat.shape[0]
    if (tuple(rows_flat.shape[1:]) != inner
            or any(tuple(t.shape) != (n,) for t in (phys, off, valid))):
        raise ValueError(
            f"fused_paged_write: shapes pages{tuple(pages.shape)} rows_flat"
            f"{tuple(rows_flat.shape)} phys{tuple(phys.shape)} off"
            f"{tuple(off.shape)} valid{tuple(valid.shape)}")
    if (pages.dtype not in _DTYPES or rows_flat.dtype != pages.dtype
            or any(t.dtype != torch.int32 for t in (phys, off, valid))):
        raise ValueError(
            f"fused_paged_write: dtypes pages {pages.dtype}, rows_flat "
            f"{rows_flat.dtype}, phys/off/valid {phys.dtype}/{off.dtype}/"
            f"{valid.dtype} (pages one of {_DTYPES}, rows the same, "
            "indices int32)")
    require_contiguous("fused_paged_write", pages=pages, rows_flat=rows_flat,
                       phys=phys, off=off, valid=valid)
    lib = _build.load("cache_write", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.paged_write_launch(ptr(pages), ptr(rows_flat), ptr(phys),
                                    ptr(off), ptr(valid), n, NP, PS,
                                    math.prod(inner), pages.element_size(),
                                    stream_ptr(dev))
    check_launch("fused_paged_write", rc)
    fused_paged_write.launches += 1
    return pages


fused_paged_write.launches = 0
