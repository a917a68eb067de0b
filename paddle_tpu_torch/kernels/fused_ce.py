"""Fused softmax cross-entropy: logits -> per-row loss and LSE in one
streaming pass, and dlogits in one elementwise pass.

Port of paddle_tpu/kernels/fused_ce.py (TPU Pallas ``ce_fwd`` and
``ce_bwd``). The CUDA kernels are ``csrc/fused_ce.cu``: one block per
row, a running (max, sum-exp) pair per thread merged across the block
(the logsumexp monoid the TPU kernel carried across its vocab grid),
16-byte loads; both directions are bound by the bytes of the logits (see
the source note there). One wrapper call is one device launch.

``valid_vocab`` masks columns at or past the real vocabulary out of the
LSE and out of the backward (padded columns get exactly zero
probability). Logits may be f32 or bf16; the math runs in f32 and the
backward writes dlogits at the logits' dtype.
"""
from __future__ import annotations

import ctypes

import torch

from . import (_build, check_launch, common_device, ptr, require_contiguous,
               stream_ptr)

__all__ = ["ce_fwd", "ce_bwd", "ce_fwd_plain", "ce_bwd_plain", "online_lse"]

_DTYPES = (torch.float32, torch.bfloat16)
_SIGNATURES = {
    "ce_fwd_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]),
    "ce_bwd_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p])}


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


def _vec(lg):
    """1 for the scalar path, else the 16-byte vector path (V a multiple
    of the vector width and a 16-byte-aligned base)."""
    width = 16 // lg.element_size()
    ok = lg.shape[1] % width == 0 and lg.data_ptr() % 16 == 0
    return width if ok else 1


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


def ce_bwd_plain(lg, labels, lse, g, valid_vocab=None):
    """Plain PyTorch backward: ``((exp(lg - lse) masked) - onehot) * g``
    in f32, cast to lg's dtype."""
    V = lg.shape[-1]
    vv = _vv(V, valid_vocab)
    ids = torch.arange(V, device=lg.device)
    p = torch.exp(lg.float() - lse.float()[:, None])
    if vv != V:
        p = torch.where(ids < vv, p, 0.0)
    onehot = (ids == labels.to(torch.int64)[:, None]).float()
    return ((p - onehot) * g.float()[:, None]).to(lg.dtype)


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
                               _vec(lg), stream_ptr(dev))
    check_launch("ce_fwd", rc)
    ce_fwd.launches += 1
    return per, lse


def ce_bwd(lg, labels, lse, g, valid_vocab=None):
    """Fused CE backward. lg [N, V] f32/bf16; labels [N] int32; lse and g
    [N] f32; contiguous, one device. On CUDA tensors launches the kernel
    (counted in ``ce_bwd.launches``); on CPU tensors runs
    ``ce_bwd_plain``. Returns dlogits [N, V] at lg's dtype."""
    dev = common_device("ce_bwd", lg, labels, lse, g)
    if dev.type == "cpu":
        return ce_bwd_plain(lg, labels, lse, g, valid_vocab)
    N, V, vv = _check("ce_bwd", lg, labels, valid_vocab)
    if (lse.dtype != torch.float32 or g.dtype != torch.float32
            or tuple(lse.shape) != (N,) or tuple(g.shape) != (N,)):
        raise ValueError(f"ce_bwd: lse {lse.dtype}{tuple(lse.shape)} and g "
                         f"{g.dtype}{tuple(g.shape)} must be f32 [{N}]")
    require_contiguous("ce_bwd", lg=lg, labels=labels, lse=lse, g=g)
    lib = _build.load("fused_ce", _SIGNATURES)
    dlg = torch.empty_like(lg)
    vec = min(_vec(lg), _vec(dlg))
    with torch.cuda.device(dev):
        rc = lib.ce_bwd_launch(ptr(lg), ptr(labels), ptr(lse), ptr(g),
                               ptr(dlg), N, V, vv,
                               int(lg.dtype == torch.bfloat16), vec,
                               stream_ptr(dev))
    check_launch("ce_bwd", rc)
    ce_bwd.launches += 1
    return dlg


ce_fwd.launches = 0
ce_bwd.launches = 0
