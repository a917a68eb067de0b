"""Fused softmax cross-entropy: logits -> per-row loss and LSE in one
streaming pass, and dlogits in one elementwise pass.

Port of paddle_tpu/kernels/fused_ce.py (TPU Pallas ``ce_fwd`` and
``ce_bwd``). The CUDA kernels are ``csrc/fused_ce.cu``; both directions
are bound by the bytes of the logits (see the source note there). Every
row streams its body in 16-byte vectors whatever V and the base offset:
``row_split`` cuts a row into a scalar head up to its first 16-byte
boundary, whole vectors and a scalar tail, and the kernels compute the
same split row by row; one block walks a row. One wrapper call is one
device launch.

``valid_vocab`` masks columns at or past the real vocabulary out of the
LSE and out of the backward (padded columns get exactly zero
probability). Logits may be f32 or bf16; the math runs in f32 and the
backward writes dlogits at the logits' dtype, or at ``out_dtype``.
"""
from __future__ import annotations

import ctypes

import torch

from . import (_build, check_launch, common_device, ptr, require_contiguous,
               stream_ptr)

__all__ = ["ce_fwd", "ce_bwd", "ce_fwd_plain", "ce_bwd_plain", "online_lse",
           "row_split", "describe"]

_DTYPES = (torch.float32, torch.bfloat16)
_SIGNATURES = {
    "ce_fwd_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]),
    "ce_bwd_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])}


def row_split(start, n, width):
    """(head, nvec, tail) of a row of ``n`` columns whose first element
    sits ``start`` elements past a 16-byte boundary, in vectors of
    ``width`` elements: a scalar head up to the first boundary (at most
    ``n``), ``nvec`` whole vectors, and a scalar tail of the rest. The
    kernels' ``row_split``."""
    head = min((width - start % width) % width, n)
    nvec = (n - head) // width
    return head, nvec, n - head - nvec * width


def _offset(t):
    """Elements of ``t``'s base past a 16-byte boundary."""
    off, elem = t.data_ptr() % 16, t.element_size()
    if off % elem:
        raise ValueError(f"fused_ce: base of a {t.dtype} tensor is not "
                         "element-aligned")
    return off // elem


def describe(lg, out_dtype=None):
    """The path a launch on ``lg`` takes, for a log line: the vector width
    in elements and the base offset."""
    other = lg.element_size() if out_dtype is None else \
        torch.empty((), dtype=out_dtype).element_size()
    width = 16 // min(lg.element_size(), other)
    return f"16-byte vectors of {width}, base +{_offset(lg)}"


def _vv(V, valid_vocab):
    return V if valid_vocab is None else int(valid_vocab)


def _masked_f32(lg, vv):
    """f32 logits with the columns at or past ``vv`` set to -inf."""
    lgf = lg.float()
    if vv != lg.shape[-1]:
        ids = torch.arange(lg.shape[-1], device=lg.device)
        lgf = torch.where(ids < vv, lgf, float("-inf"))
    return lgf


def online_lse(lg, valid_vocab=None):
    """Row log-sum-exp over the last axis in f32, columns at or past
    ``valid_vocab`` masked. The guard of paddle_tpu's ``online_lse``: a row
    whose every column is masked gives -inf, never ``exp(-inf - -inf)``
    = nan."""
    lgf = _masked_f32(lg, _vv(lg.shape[-1], valid_vocab))
    m = lgf.amax(-1)
    m_safe = torch.where(m == float("-inf"), 0.0, m)
    s = torch.exp(lgf - m_safe[..., None]).sum(-1)
    return torch.log(s) + m_safe


def _check(op, lg, labels, valid_vocab):
    N, V = lg.shape
    if lg.dtype not in _DTYPES or labels.dtype != torch.int32:
        raise ValueError(f"{op}: dtypes lg {lg.dtype} (f32 or bf16), labels "
                         f"{labels.dtype} (int32)")
    if tuple(labels.shape) != (N,):
        raise ValueError(f"{op}: labels{tuple(labels.shape)} for lg "
                         f"{tuple(lg.shape)}")
    vv = _vv(V, valid_vocab)
    if not 0 < vv <= V:
        raise ValueError(f"{op}: valid_vocab {vv} outside (0, {V}]")
    return N, V, vv


def ce_fwd_plain(lg, labels, valid_vocab=None):
    """Plain PyTorch forward: (per [N] f32, lse [N] f32) with
    ``per = lse - lg[label]``; a label at or past ``valid_vocab`` picks
    -inf, one outside [0, V) picks 0, as the TPU kernel's masked one-hot
    sum does."""
    V = lg.shape[-1]
    vv = _vv(V, valid_vocab)
    lse = online_lse(lg, vv)
    lab = labels.to(torch.int64)
    inside = (lab >= 0) & (lab < V)
    gold = _masked_f32(lg, vv).gather(1, lab.clamp(0, V - 1)[:, None])[:, 0]
    gold = torch.where(inside, gold, 0.0)
    return lse - gold, lse


def ce_bwd_plain(lg, labels, lse, g, valid_vocab=None, out_dtype=None):
    """Plain PyTorch backward: ``((exp(lg - lse) masked) - onehot) * g``
    in f32, cast to ``out_dtype`` (default lg's dtype)."""
    V = lg.shape[-1]
    vv = _vv(V, valid_vocab)
    ids = torch.arange(V, device=lg.device)
    p = torch.exp(lg.float() - lse.float()[:, None])
    if vv != V:
        p = torch.where(ids < vv, p, 0.0)
    onehot = (ids == labels.to(torch.int64)[:, None]).float()
    return ((p - onehot) * g.float()[:, None]).to(out_dtype or lg.dtype)


def ce_fwd(lg, labels, valid_vocab=None):
    """Fused CE forward. lg [N, V] f32/bf16; labels [N] int32 (the caller
    clips them to [0, V)); contiguous, one device. On CUDA tensors
    launches the kernel (counted in ``ce_fwd.launches``); on CPU tensors
    runs ``ce_fwd_plain``. Returns (per [N] f32, lse [N] f32)."""
    dev = common_device("ce_fwd", lg, labels)
    if dev.type == "cpu":
        return ce_fwd_plain(lg, labels, valid_vocab)
    N, V, vv = _check("ce_fwd", lg, labels, valid_vocab)
    require_contiguous("ce_fwd", lg=lg, labels=labels)
    lib = _build.load("fused_ce", _SIGNATURES)
    per = torch.empty(N, dtype=torch.float32, device=dev)
    lse = torch.empty(N, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ce_fwd_launch(ptr(lg), ptr(labels), ptr(per), ptr(lse), N,
                               V, vv, int(lg.dtype == torch.bfloat16),
                               _offset(lg), stream_ptr(dev))
    check_launch("ce_fwd", rc)
    ce_fwd.launches += 1
    return per, lse


def _like_offset(lg, dtype):
    """An empty ``[N, V]`` tensor of ``dtype`` whose base sits as far past
    a 16-byte boundary as ``lg``'s (modulo the wider type's vector), so
    that a 16-byte boundary of one's rows is one of the other's: a fresh
    tensor where ``lg`` is aligned, else a view into a few more
    elements."""
    N, V = lg.shape
    elem = torch.empty((), dtype=dtype).element_size()
    step = 16 // max(elem, lg.element_size())
    want = _offset(lg) % step
    if want == 0:
        return torch.empty((N, V), dtype=dtype, device=lg.device)
    buf = torch.empty(N * V + 16 // elem, dtype=dtype, device=lg.device)
    k = (want - _offset(buf)) % step
    return buf[k:k + N * V].view(N, V)


def ce_bwd(lg, labels, lse, g, valid_vocab=None, out_dtype=None):
    """Fused CE backward. lg [N, V] f32/bf16; labels [N] int32; lse and g
    [N] f32; contiguous, one device. On CUDA tensors launches the kernel
    (counted in ``ce_bwd.launches``); on CPU tensors runs
    ``ce_bwd_plain``. Returns dlogits [N, V] at ``out_dtype`` (f32 or
    bf16; default lg's dtype), each value the f32 result rounded to
    nearest even as ``.to(out_dtype)`` rounds it."""
    dev = common_device("ce_bwd", lg, labels, lse, g)
    if dev.type == "cpu":
        return ce_bwd_plain(lg, labels, lse, g, valid_vocab, out_dtype)
    N, V, vv = _check("ce_bwd", lg, labels, valid_vocab)
    out_dtype = out_dtype or lg.dtype
    if out_dtype not in _DTYPES:
        raise ValueError(f"ce_bwd: out_dtype {out_dtype} (f32 or bf16)")
    if (lse.dtype != torch.float32 or g.dtype != torch.float32
            or tuple(lse.shape) != (N,) or tuple(g.shape) != (N,)):
        raise ValueError(f"ce_bwd: lse {lse.dtype}{tuple(lse.shape)} and g "
                         f"{g.dtype}{tuple(g.shape)} must be f32 [{N}]")
    require_contiguous("ce_bwd", lg=lg, labels=labels, lse=lse, g=g)
    lib = _build.load("fused_ce", _SIGNATURES)
    dlg = _like_offset(lg, out_dtype)
    narrow = dlg if dlg.element_size() < lg.element_size() else lg
    with torch.cuda.device(dev):
        rc = lib.ce_bwd_launch(ptr(lg), ptr(labels), ptr(lse), ptr(g),
                               ptr(dlg), N, V, vv,
                               int(lg.dtype == torch.bfloat16),
                               int(out_dtype == torch.bfloat16),
                               _offset(narrow), stream_ptr(dev))
    check_launch("ce_bwd", rc)
    ce_bwd.launches += 1
    return dlg


ce_fwd.launches = 0
ce_bwd.launches = 0
