"""KV-cache writes: the slot form ``cache[b, pos[b]] = rows[b, 0]`` and
the paged form ``pages[bt[b, t // PS], t % PS] = rows[b, s]``.

Port of paddle_tpu/kernels/cache_write.py (TPU Pallas): ``fused_slot_write``
(B3 slot) and ``fused_paged_write`` (B3 paged). The CUDA kernels are in
``csrc/cache_write.cu`` and touch only the new rows, so a launch is bound by
launch latency, not bytes (see the source note there). The serving paths
take the fused forms, one launch a layer each:

- ``kv_slot_write``: up to four slot planes at ``pos[b]`` (the int8 slot
  decode's k data, k scale, v data and v scale);
- ``kv_paged_write``: both halves of a paged cache, with the block-table
  index arithmetic, the write gates, the cast to the pool's type and the
  int8 quantisation inside the launch (paddle_tpu's ``_paged_cache_write``
  body around two ``fused_paged_write`` calls).

``fused_slot_write`` (one plane, on the slot kernel) and
``fused_paged_write`` (one pool leaf from precomputed indices) stay as the
per-plane counterparts of the TPU functions.

Unlike the JAX functions, which return new caches aliased to the old,
these update the caches IN PLACE.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import (_build, check_launch, common_device, ptr, require_contiguous,
               stream_ptr)

__all__ = ["fused_slot_write", "fused_slot_write_plain",
           "fused_paged_write", "fused_paged_write_plain",
           "kv_slot_write", "kv_slot_write_plain",
           "kv_paged_write", "kv_paged_write_plain", "quant_rows"]

_DTYPES = (torch.int8, torch.float32, torch.bfloat16)
_ROW_DTYPES = (torch.float32, torch.bfloat16)      # the kernel's src codes
_POOL_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_PLANES = 4
_GROUP_MAX = 32            # lanes of one (half, row, head) in kv_paged_write
_P = ctypes.c_void_p
_I, _LL = ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "kv_slot_write_launch": (_I, [_I, _P, _P, _P, _P, _P, _I, _I, _P]),
    "kv_paged_write_launch": (_I, [
        _I, _P, _P, _P, _P, _I, _I, _P, _LL, _P, _LL, _P, _LL]
        + [_I] * 9 + [_P]),
    "paged_write_launch": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _LL, _I,
                                _P])}
# the 0-dim divisor of quant_rows, kept per device
_DIV127: dict = {}


def quant_rows(x):
    """Per-(b, s, head) symmetric int8 quantisation of [..., hd]:
    ``scale = amax / 127`` and ``round(x / max(scale, 1e-12))``, round half
    to even as jnp.round, in IEEE division everywhere. The divisor 127 is a
    0-dim tensor on x's device: divided by a Python number, a CUDA tensor
    is multiplied by the number's f32 reciprocal instead, which is one ulp
    off amax / 127 for some amax."""
    xf = x.float()
    d = _DIV127.get(xf.device)
    if d is None:
        d = _DIV127[xf.device] = torch.tensor(127.0, device=xf.device)
    scale = xf.abs().amax(-1) / d
    q = torch.round(xf / torch.clamp(scale, min=1e-12)[..., None])
    return q.to(torch.int8), scale


# ------------------------------------------------------------- slot form

def fused_slot_write_plain(cache, rows, pos):
    """Plain PyTorch version: rows whose position lies in [0, L) land at
    ``cache[b, pos[b]]`` (cast to the cache dtype); others write nothing."""
    return _slot_rows(cache, rows, pos)


def _slot_rows(cache, rows, pos):
    L = cache.shape[1]
    pos = pos.to(torch.int64)
    hit = ((pos >= 0) & (pos < L)).nonzero()[:, 0]
    cache[hit, pos[hit]] = rows[hit, 0].to(cache.dtype)
    return cache


def kv_slot_write_plain(caches, rows, pos):
    """Plain PyTorch version of ``kv_slot_write``: the math of
    ``fused_slot_write_plain`` on each plane."""
    for cache, r in zip(caches, rows):
        _slot_rows(cache, r, pos)
    return caches


def _unit(nbytes: int, *tensors) -> int:
    """The largest of 16, 8, 4, 2, 1 bytes dividing ``nbytes`` to which
    every tensor's data pointer is aligned."""
    for u in (16, 8, 4, 2):
        if nbytes % u == 0 and all(t.data_ptr() % u == 0 for t in tensors):
            return u
    return 1


def _slot_launch(op, caches, rows, pos):
    """Check and launch the slot kernel on 1-4 planes (CUDA tensors)."""
    dev = common_device(op, *caches, *rows, pos)
    n = len(caches)
    if not 1 <= n <= _MAX_PLANES or len(rows) != n:
        raise ValueError(f"{op}: {n} caches and {len(rows)} rows (1 to "
                         f"{_MAX_PLANES} planes, a rows tensor for each)")
    B, L = caches[0].shape[0], caches[0].shape[1]
    if tuple(pos.shape) != (B,) or pos.dtype != torch.int32:
        raise ValueError(f"{op}: pos {tuple(pos.shape)} {pos.dtype} (int32 "
                         f"[{B}])")
    row_bytes, units = [], []
    for i, (c, r) in enumerate(zip(caches, rows)):
        inner = tuple(c.shape[2:])
        if (tuple(c.shape[:2]) != (B, L)
                or tuple(r.shape) != (B, 1) + inner):
            raise ValueError(f"{op}: plane {i}: shapes cache"
                             f"{tuple(c.shape)} rows{tuple(r.shape)} (all "
                             f"caches [{B}, {L}, ...], rows [{B}, 1, ...])")
        if c.dtype not in _DTYPES or r.dtype != c.dtype:
            raise ValueError(f"{op}: plane {i}: dtypes cache {c.dtype}, "
                             f"rows {r.dtype} (cache one of {_DTYPES}, rows "
                             "the same)")
        require_contiguous(op, cache=c, rows=r)
        nbytes = math.prod(inner) * c.element_size()
        row_bytes.append(nbytes)
        units.append(_unit(nbytes, c, r))
    require_contiguous(op, pos=pos)
    lib = _build.load("cache_write", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.kv_slot_write_launch(
            n, (_P * n)(*(c.data_ptr() for c in caches)),
            (_P * n)(*(r.data_ptr() for r in rows)),
            (_LL * n)(*row_bytes), (_I * n)(*units), ptr(pos), B, L,
            stream_ptr(dev))
    check_launch(op, rc)


def fused_slot_write(cache, rows, pos):
    """One-launch S=1 slot write of one plane.

    cache [B, L, ...] int8 / f32 / bf16 (the [B, L, nkv, hd] data array or
    the [B, L, nkv] int8-cache scale plane); rows [B, 1, ...] of the same
    dtype; pos [B] int32; all contiguous, all on one device. On CUDA
    tensors launches the slot kernel with one plane (counted in
    ``fused_slot_write.launches``); on CPU tensors runs
    ``fused_slot_write_plain``. Returns ``cache``, updated in place.
    """
    if common_device("fused_slot_write", cache, rows, pos).type == "cpu":
        return fused_slot_write_plain(cache, rows, pos)
    _slot_launch("fused_slot_write", [cache], [rows], pos)
    fused_slot_write.launches += 1
    return cache


fused_slot_write.launches = 0


def kv_slot_write(caches, rows, pos):
    """One launch writes up to four slot planes: ``caches[i][b, pos[b]] =
    rows[i][b, 0]`` where ``0 <= pos[b] < L``.

    caches: 1-4 contiguous [B, L, ...] tensors (int8 / f32 / bf16, the
    inner shapes may differ: the int8 slot decode passes k data, k scale,
    v data, v scale); rows: as many [B, 1, ...] tensors of the matching
    dtype and shape (pre-quantised for int8); pos [B] int32. On CUDA
    tensors launches the kernel once (counted in ``kv_slot_write.launches``);
    on CPU tensors runs ``kv_slot_write_plain``. Returns ``caches``,
    updated in place.
    """
    if common_device("kv_slot_write", *caches, *rows, pos).type == "cpu":
        return kv_slot_write_plain(caches, rows, pos)
    _slot_launch("kv_slot_write", list(caches), list(rows), pos)
    kv_slot_write.launches += 1
    return caches


kv_slot_write.launches = 0


# ------------------------------------------------------------ paged form

def fused_paged_write_plain(pages, rows_flat, phys, off, valid):
    """Plain PyTorch version: row i lands at ``pages[phys[i], off[i]]``
    where ``valid[i] != 0``, ``0 <= phys[i] < NP`` and ``0 <= off[i] <
    PS``; other rows write nothing. Where valid rows collide, the last one
    wins, as in the TPU kernel's sequential loop."""
    return _paged_rows(pages, rows_flat, phys, off, valid)


def _paged_rows(pages, rows_flat, phys, off, valid):
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
    """One-launch paged-pool write of one pool leaf.

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


def _halves(k, v, k_pool, v_pool):
    """[(rows, pool)] of the halves given: v and v_pool both or neither."""
    if (v is None) != (v_pool is None):
        raise ValueError("kv_paged_write: v and v_pool go together")
    return [(k, k_pool)] + ([] if v is None else [(v, v_pool)])


def kv_paged_write_plain(k, v, k_pool, v_pool, bt, pos, live=None,
                         wlen=None):
    """Plain PyTorch version of ``kv_paged_write``: paddle_tpu's
    ``_paged_cache_write`` body on each half — the (page, offset, gate)
    arithmetic, then the math of ``fused_paged_write_plain`` on each pool
    leaf (int8 rows through ``quant_rows``)."""
    halves = _halves(k, v, k_pool, v_pool)
    pages = k_pool["pages"]
    PS, dev = pages.shape[1], pages.device
    B, S = k.shape[0], k.shape[1]
    bt = bt.long()
    PM = bt.shape[1]
    s_ids = torch.arange(S, device=dev)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        base = pos.to(torch.int64)[:, None]
    else:
        base = torch.full((B, 1), int(pos), dtype=torch.int64, device=dev)
    t = base + s_ids[None, :]                                # [B, S]
    valid = t < PM * PS
    if live is not None:
        valid = valid & live[:, None]
    if wlen is not None:
        valid = valid & (s_ids[None, :] < wlen)
    page_slot = torch.clamp(torch.div(t, PS, rounding_mode="floor"), 0,
                            PM - 1)
    n = B * S
    phys = torch.gather(bt, 1, page_slot).reshape(n).to(torch.int32)
    off = torch.remainder(t, PS).reshape(n).to(torch.int32)
    valid = valid.reshape(n).to(torch.int32)
    for rows, pool in halves:
        if "scale" in pool:
            qrows, scale = quant_rows(rows)
            _paged_rows(pool["pages"], qrows.reshape(
                (n,) + qrows.shape[2:]), phys, off, valid)
            _paged_rows(pool["scale"], scale.reshape(
                (n,) + scale.shape[2:]), phys, off, valid)
        else:
            _paged_rows(pool["pages"], rows.reshape(
                (n,) + rows.shape[2:]), phys, off, valid)
    return k_pool, v_pool


def lane_plan(hd, el_src, el_dst, src_ptrs, strides, dst_ptrs):
    """(vec, group) of a ``kv_paged_write`` launch: each lane moves chunks
    of ``vec`` elements, the most that a 16-byte store of the pool's type
    holds and that ``hd``, every source row (pointer and element strides)
    and every pool row allow; ``group`` lanes (a power of 2, at most 32)
    share one (half, row, head), enough for one chunk each."""
    vec = 16 // el_dst
    while vec > 1 and not (
            hd % vec == 0
            and all(p % (vec * el_src) == 0 for p in src_ptrs)
            and all(s % vec == 0 for s in strides)
            and all(p % (vec * el_dst) == 0 for p in dst_ptrs)):
        vec //= 2
    return vec, min(_GROUP_MAX, 1 << (hd // vec - 1).bit_length())


def _launch_kv_paged(halves, bt, pos, live, wlen, dev):
    """Check the CUDA arguments of ``kv_paged_write`` and launch."""
    op = "kv_paged_write"
    k, k_pool = halves[0]
    B, S, nkv, hd = k.shape
    pages = k_pool["pages"]
    NP, PS = pages.shape[0], pages.shape[1]
    quant = pages.dtype == torch.int8
    if (pages.dtype not in _DTYPES or k.dtype not in _ROW_DTYPES
            or tuple(pages.shape) != (NP, PS, nkv, hd)):
        raise ValueError(f"{op}: rows {tuple(k.shape)} {k.dtype} (f32 or "
                         f"bf16 [B, S, nkv, hd]) into pages "
                         f"{tuple(pages.shape)} {pages.dtype} (one of "
                         f"{_DTYPES}, [NP, PS, nkv, hd])")
    srcs, strides, dsts, scales = [], [], [], []
    for rows, pool in halves:
        p = pool["pages"]
        if (rows.shape != k.shape or rows.dtype != k.dtype
                or p.shape != pages.shape or p.dtype != pages.dtype
                or ("scale" in pool) != quant):
            raise ValueError(f"{op}: the two halves differ in shape or "
                             "dtype, or an int8 pool lacks its scale plane")
        if rows.stride(3) != 1:
            raise ValueError(f"{op}: rows need an innermost stride of 1, "
                             f"got strides {rows.stride()}")
        require_contiguous(op, pages=p)
        srcs.append(rows)
        strides += [rows.stride(0), rows.stride(1), rows.stride(2)]
        dsts.append(p)
        if quant:
            sc = pool["scale"]
            if sc.dtype != torch.float32 or tuple(sc.shape) != (NP, PS,
                                                                 nkv):
                raise ValueError(f"{op}: scale plane {tuple(sc.shape)} "
                                 f"{sc.dtype} (f32 [{NP}, {PS}, {nkv}])")
            require_contiguous(op, scale=sc)
            scales.append(sc)
    if bt.ndim != 2 or bt.shape[0] != B or bt.dtype != torch.int64:
        raise ValueError(f"{op}: bt {tuple(bt.shape)} {bt.dtype} (int64 "
                         f"[{B}, PM])")
    if bt.stride(1) != 1:
        raise ValueError(f"{op}: bt needs contiguous rows")
    per_row = isinstance(pos, torch.Tensor)
    if per_row and (tuple(pos.shape) != (B,) or pos.dtype != torch.int32):
        raise ValueError(f"{op}: pos {tuple(pos.shape)} {pos.dtype} (an int "
                         f"or int32 [{B}])")
    if per_row:
        require_contiguous(op, pos=pos)
    if live is not None:
        if tuple(live.shape) != (B,) or live.dtype != torch.bool:
            raise ValueError(f"{op}: live {tuple(live.shape)} {live.dtype} "
                             f"(bool [{B}])")
        require_contiguous(op, live=live)
    if isinstance(wlen, torch.Tensor):
        raise ValueError(f"{op}: wlen must be an int (reading a tensor "
                         "would sync with the card)")
    vec, group = lane_plan(hd, k.element_size(), pages.element_size(),
                           [t.data_ptr() for t in srcs], strides,
                           [t.data_ptr() for t in dsts])
    n = len(halves)
    scale_ptrs = [t.data_ptr() for t in scales] if quant else [None] * n
    lib = _build.load("cache_write", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.kv_paged_write_launch(
            n, (_P * n)(*(t.data_ptr() for t in srcs)),
            (_LL * (3 * n))(*strides),
            (_P * n)(*(t.data_ptr() for t in dsts)), (_P * n)(*scale_ptrs),
            _ROW_DTYPES.index(k.dtype), _POOL_CODES[pages.dtype],
            ptr(bt), bt.stride(0),
            ptr(pos) if per_row else None, 0 if per_row else int(pos),
            ptr(live) if live is not None else None,
            -1 if wlen is None else int(wlen),
            B, S, nkv, hd, NP, PS, bt.shape[1], vec, group, stream_ptr(dev))
    check_launch(op, rc)


def kv_paged_write(k, v, k_pool, v_pool, bt, pos, live=None, wlen=None):
    """One launch writes the new k and v rows of a layer into their paged
    pools: row (b, s) of each half lands at global position t = pos + s
    (or pos[b] + s), page ``bt[b, clamp(t // PS, 0, PM - 1)]``, offset
    ``t % PS`` (floor semantics), where ``t < PM * PS``, ``live[b]`` and
    ``s < wlen``, and only into a page in [0, NP).

    k, v: [B, S, nkv, hd] f32 / bf16, any strides with the innermost 1 (the
    views the qkv projection gives); k_pool, v_pool: pool-half dicts with
    ``"pages"`` [NP, PS, nkv, hd] (f32, bf16 or int8) and, for int8,
    ``"scale"`` [NP, PS, nkv] f32 — rows are cast to the pool's type, or
    quantised per (row, head) for int8 as ``quant_rows`` does; v and v_pool
    may both be None (one half). bt: [B, PM] int64 block table, as the
    engine holds it (the plain version takes any integer type); pos: an int or a [B] int32 tensor; live: [B] bool
    or None; wlen: an int or None. Valid rows must target distinct (page,
    offset) pairs (copy-on-write). On CUDA tensors launches the kernel once
    (counted in ``kv_paged_write.launches``); on CPU tensors runs
    ``kv_paged_write_plain``. Returns (k_pool, v_pool), updated in place.
    """
    halves = _halves(k, v, k_pool, v_pool)
    tensors = [t for rows, pool in halves
               for t in (rows, pool["pages"], pool.get("scale"))
               if t is not None] + [bt]
    tensors += [t for t in (pos, live) if isinstance(t, torch.Tensor)]
    dev = common_device("kv_paged_write", *tensors)
    if dev.type == "cpu":
        return kv_paged_write_plain(k, v, k_pool, v_pool, bt, pos, live,
                                    wlen)
    _launch_kv_paged(halves, bt, pos, live, wlen, dev)
    kv_paged_write.launches += 1
    return k_pool, v_pool


kv_paged_write.launches = 0
