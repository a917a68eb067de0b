"""Mega-kernel decode inner step: cache read -> attention -> cache write for
one layer in one launch.

Port of paddle_tpu/kernels/mega_decode.py:mega_decode_step (TPU Pallas;
math in ``_attend``). The CUDA kernel is ``csrc/mega_decode.cu``: the grid
is (batch row x kv head x sub-group, chunk of the cache). Each block walks
its chunk of the OLD cache under a strict ``l < pos[b]`` mask with an
online softmax in f32 and writes a partial state to a workspace; the last
block of each (batch row, kv head, sub-group) merges the partials with the
incoming k/v row at its incoming precision and writes ctx, and sub-group
0's writes the new row at ``pos[b]`` when ``0 <= pos[b] < L``. It is
bound by the cache bytes it reads (see the source note there).

GQA takes any group count g = nh / nkv, as paddle_tpu does: a block
holds ``G <= 8`` query heads of its kv head (``sub_groups``), and g above 8
runs ``g / G`` sub-groups of them as a grid axis of the same launch.

``plan_chunks`` picks the chunk length from the shape and the SM count
alone, never from ``pos`` (reading it would sync the host with the card).
The workspace and the merge's ticket counters are allocated once per
(device, stream, shape) and reused; the kernel leaves the counters at 0.

Unlike the JAX function, which returns new caches aliased to the old,
this one updates ``kc`` and ``vc`` IN PLACE and returns them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import (_build, check_launch, common_device, ptr, require_contiguous,
               stream_ptr)

__all__ = ["mega_decode_step", "mega_decode_step_plain", "plan_chunks",
           "sub_groups"]

_NEG_INF = -1e30
# query heads a block takes at most: the kernel's template is instantiated
# for G = 1..8 (its accumulators are acc[G][hd] a row group)
_MAX_BLOCK_GROUP = 8
_MAX_HEAD_DIM = 256
# chunks are a multiple of this many rows (a block reads 16-64 rows of a
# head in one batch of loads); at most this many chunks (the merge folds
# them one after another)
_CHUNK_ROWS = 64
_MAX_CHUNKS = 64
# blocks per SM a launch aims at, so a full cache fills the card several
# times over and a short one still spreads
_BLOCKS_PER_SM = 8
_SIGNATURES = {"mega_decode_launch": (ctypes.c_int, [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p] + [ctypes.c_int] * 11 + [ctypes.c_float,
                                              ctypes.c_void_p])}
_workspaces: dict = {}


def _scale(hd: int) -> float:
    return 1.0 / float(hd) ** 0.5


def plan_chunks(B: int, nkv: int, L: int, sm_count: int) -> tuple:
    """(chunk, nchunks): the kernel's split of the cache rows [0, L) into
    ``nchunks`` chunks of ``chunk`` rows (the last may be shorter, none is
    empty), so that the B * nkv * nchunks blocks come to about
    ``_BLOCKS_PER_SM`` per SM. ``chunk`` is a multiple of ``_CHUNK_ROWS``
    and ``nchunks`` at most ``_MAX_CHUNKS``."""
    if min(B, nkv, L, sm_count) < 1:
        raise ValueError(f"plan_chunks: B={B} nkv={nkv} L={L} "
                         f"sm_count={sm_count}")
    want = -(-_BLOCKS_PER_SM * sm_count // (B * nkv))
    chunk = max(-(-L // want), -(-L // _MAX_CHUNKS))
    chunk = -(-chunk // _CHUNK_ROWS) * _CHUNK_ROWS
    return chunk, -(-L // chunk)


def sub_groups(g: int) -> tuple:
    """(G, nsub): the g query heads of a kv head as ``nsub`` sub-groups
    of ``G`` heads, G the largest divisor of g up to 8 (16 -> (8, 2), 12 ->
    (6, 2), 5 -> (5, 1), 11 -> (1, 11))."""
    if g < 1:
        raise ValueError(f"sub_groups: g={g}")
    G = next(d for d in range(min(g, _MAX_BLOCK_GROUP), 0, -1) if g % d == 0)
    return G, g // G


def workspace_floats(B: int, nkv: int, nchunks: int, g: int,
                     hd: int) -> int:
    """f32 workspace of one launch: (m, s) and acc[G][hd] per partial of
    each of the g / G sub-groups, so g * (hd + 2) per (row, kv head,
    chunk) whatever the split."""
    return B * nkv * nchunks * g * (hd + 2)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _vec_bytes(hd: int, elem: int, *tensors) -> int:
    """The widest load (16, 8, 4 or 2 bytes) that divides a cache row and
    the alignment of every base pointer."""
    for vb in (16, 8, 4, 2):
        if (vb >= elem and hd * elem % vb == 0
                and all(t.data_ptr() % vb == 0 for t in tensors)):
            return vb
    raise ValueError(f"mega_decode_step: no load width for hd={hd}")


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
    [B,L,nkv,hd] f32 or bf16 (one dtype); pos [B] int32; nh a multiple
    of nkv (any group count); hd <= 256. All contiguous, all on one
    device. On CUDA tensors launches the kernel (counted in
    ``mega_decode_step.launches``); on CPU tensors runs
    ``mega_decode_step_plain``. Returns
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
    if nh % nkv or hd > _MAX_HEAD_DIM:
        raise ValueError(f"mega_decode_step: nh={nh} nkv={nkv} hd={hd} "
                         f"(need nh a multiple of nkv, hd <= "
                         f"{_MAX_HEAD_DIM})")
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
    g = nh // nkv
    G, nsub = sub_groups(g)
    # the sub-groups are blocks of their own: the plan spreads them all
    chunk, nchunks = plan_chunks(B, nkv * nsub, L, _sm_count(dev.index))
    stream = stream_ptr(dev)
    key = (dev.index, stream.value, B, nkv, nchunks, g, hd)
    if key not in _workspaces:
        _workspaces[key] = (
            torch.empty(workspace_floats(B, nkv, nchunks, g, hd),
                        dtype=torch.float32, device=dev),
            torch.zeros(B * nkv * nsub, dtype=torch.int32, device=dev))
    ws, counters = _workspaces[key]
    ctx = torch.empty_like(q)
    with torch.cuda.device(dev):
        rc = lib.mega_decode_launch(
            ptr(q), ptr(k), ptr(v), ptr(kc), ptr(vc), ptr(pos), ptr(ctx),
            ptr(ws), ptr(counters), B, L, nkv, G, nsub, hd, chunk, nchunks,
            _vec_bytes(hd, kc.element_size(), kc, vc),
            int(q.dtype == torch.bfloat16), int(kc.dtype == torch.bfloat16),
            _scale(hd), stream)
    check_launch("mega_decode_step", rc)
    mega_decode_step.launches += 1
    return ctx, kc, vc


mega_decode_step.launches = 0
