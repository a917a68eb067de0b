"""Flash attention forward and backward on ``(B, H, S, D)``, returning the
log-sum-exp, with runtime query/key offsets for causal masking.

Port of the TPU kernel behind paddle_tpu/nn/functional/flash_attention.py:
``_pallas_flash`` (the library Pallas flash-attention kernel and its
backward); the math is the one paddle_tpu writes out in
kernels/flash_block.py (``_fwd``, ``_bwd``, ``compute_delta``). Three CUDA
sources, chosen by ``_tc_path`` from the dtype and D alone:

=================  =================================================
inputs             kernels
=================  =================================================
bf16, D 64 or 128  ``csrc/flash_attention_sm90.cu``: wgmma on the
                   tensor cores, TMA-fed K/V rings (``*_tc_launch``)
f32, D 64          ``csrc/flash_attention_sm90_f32.cu``: 3xTF32
                   mma.sync on the tensor cores, cp.async-fed rings
                   (``*_tf32_launch``)
f32 at another D;  ``csrc/flash_attention.cu``: f32 FMAs on the CUDA
bf16 at another D  cores, a 64-row tile per block (``*_launch``)
=================  =================================================

The first two are the tensor-core path (``_tc_path`` True), the last the
SIMT path. Launches per wrapper call (each call counts once in
``.launches`` and once in its path's ``.tc_launches`` or
``.simt_launches``): ``flash_attn_fwd`` issues one device launch;
``flash_attn_bwd`` issues two, the dQ pass (which also computes ``delta =
rowsum(dO * O)``) and then the dK/dV pass.

Contract, as flash_block's: f32 accumulation; a row whose every key is
masked returns ``out = 0``, ``lse = -inf`` and zero gradients. ``q_off``
and ``k_off`` are the global positions of ``q[0]`` and ``k[0]``; causal
keeps ``q_off + i >= k_off + j`` (top-left aligned at 0/0). The LSE is
``[B, H, Sq]`` f32 (not the TPU's lane-broadcast ``[.., 128]`` form).

Precision: paddle_tpu's B5 kernels take every product as an f32 product
of the inputs (kernels/flash_block.py's ``_fwd_kernel`` and ``_bwd`` widen
q, k and v to f32). The SIMT kernels do the same. The bf16 tensor-core
kernels carry P and dS into their bf16 products as bf16 parts: P in the
forward as three (within 2^-24, as f32: out feeds the backward's
``delta``), P and dS in the backward as two (within 2^-16). The f32
tensor-core kernels take every product of f32 inputs as a 3xTF32 product
(each operand split into a TF32 big and small part, big.big + big.small +
small.big), within ~2^-21 of the f32 product, as PyTorch's f32
memory-efficient attention does. ``_pallas_flash`` rounds P and dS to bf16
instead; every path computes its function at least as precisely. So one
plain version, f32 products with the result cast to the inputs' dtype,
holds all three.

The operators ``paddle_tpu_torch::flash_attn`` (forward) and
``paddle_tpu_torch::flash_attn_grad`` (backward) put the two wrappers
behind ``torch.library.custom_op``: training differentiates through
``flash_attn`` (its registered backward calls ``flash_attn_grad``), and
``torch.export`` (``jit.save``) records the call as one node that
survives ``export -> save -> load``, which a ``ctypes`` launch alone does
not. Their fake implementations give the output shapes and launch
nothing; the launch counters move only inside the wrappers.
"""
from __future__ import annotations

import ctypes

import torch

from . import (_build, check_launch, common_device, ptr, require_contiguous,
               stream_ptr)

__all__ = ["flash_attn_fwd", "flash_attn_bwd", "flash_attn_fwd_plain",
           "flash_attn_bwd_plain", "flash_attn", "flash_attn_grad"]

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_HEAD_DIM = 128
_TC_HEAD_DIMS = {torch.bfloat16: (64, 128), torch.float32: (64,)}
_NEG_INF = float("-inf")
_GEO = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# one table per library: kernels/flash_block.py (B5) loads them too, and a
# library's signatures are applied once, at its first load
_SIGNATURES = {
    "flash_fwd_launch": (ctypes.c_int, [ctypes.c_void_p] * 5 + _GEO),
    "flash_bwd_launch": (ctypes.c_int, [ctypes.c_void_p] * 10 + _GEO),
    "flash_block_bwd_launch": (ctypes.c_int, [ctypes.c_void_p] * 9 + _GEO)}
_TC_SIGNATURES = {
    "flash_fwd_tc_launch": (ctypes.c_int, [ctypes.c_void_p] * 5 + _GEO),
    "flash_bwd_tc_launch": (ctypes.c_int, [ctypes.c_void_p] * 10 + _GEO),
    "flash_block_bwd_tc_launch": (ctypes.c_int,
                                  [ctypes.c_void_p] * 9 + _GEO),
    "flash_tc_smem_bytes": (ctypes.c_int, [ctypes.c_int] * 3)}
_TF32_SIGNATURES = {
    "flash_fwd_tf32_launch": (ctypes.c_int, [ctypes.c_void_p] * 5 + _GEO),
    "flash_bwd_tf32_launch": (ctypes.c_int, [ctypes.c_void_p] * 10 + _GEO),
    "flash_block_bwd_tf32_launch": (ctypes.c_int,
                                    [ctypes.c_void_p] * 9 + _GEO),
    "flash_tf32_smem_bytes": (ctypes.c_int, [ctypes.c_int] * 2)}


def _tc_path(dtype, D) -> bool:
    """True where the tensor-core kernels run (bf16 at D 64 or 128, f32 at
    D 64), False where the SIMT ones do (every other D). Decided from dtype
    and D alone, never from a failure: a refused launch raises."""
    return int(D) in _TC_HEAD_DIMS.get(dtype, ())


def _entry(tc, dtype, name):
    """The C entry ``name`` of the path's library, built at first use:
    ``<name>_tc_launch`` (bf16) or ``<name>_tf32_launch`` (f32) on the
    tensor-core path, ``<name>_launch`` on the SIMT one."""
    if not tc:
        return getattr(_build.load("flash_attention", _SIGNATURES),
                       f"{name}_launch")
    if dtype == torch.bfloat16:
        return getattr(_build.load("flash_attention_sm90", _TC_SIGNATURES),
                       f"{name}_tc_launch")
    return getattr(_build.load("flash_attention_sm90_f32", _TF32_SIGNATURES),
                   f"{name}_tf32_launch")


def _require_tma_aligned(op, **tensors):
    """The tensor-core path reads these in 16-byte copies (TMA for bf16,
    cp.async and 16-byte loads for f32): 16-byte aligned bases."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must be 16-byte aligned on the "
                             "tensor-core path (16-byte copies)")


def _count(wrapper, tc):
    wrapper.launches += 1
    if tc:
        wrapper.tc_launches += 1
    else:
        wrapper.simt_launches += 1


def _acc(t):
    """The accumulation dtype: f32, or f64 for f64 inputs (gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


def _scores(q, k, causal, sm_scale, q_off, k_off):
    """``[B, H, Sq, Sk]`` scaled scores at the accumulation dtype, -inf
    where causal masking hides the key."""
    a = _acc(q)
    s = torch.matmul(q.to(a), k.to(a).transpose(-1, -2)) * sm_scale
    if not causal:
        return s
    qi = torch.arange(q.shape[2], device=q.device)[:, None] + int(q_off)
    ki = torch.arange(k.shape[2], device=q.device)[None, :] + int(k_off)
    return torch.where(qi >= ki, s, _NEG_INF)


def flash_attn_fwd_plain(q, k, v, causal, sm_scale, q_off=0, k_off=0):
    """Plain PyTorch forward, materialising the ``[B, H, Sq, Sk]`` scores
    in f32 (f64 for f64 inputs). Returns (out at q's dtype, lse [B, H,
    Sq] at the accumulation dtype)."""
    s = _scores(q, k, causal, sm_scale, q_off, k_off)
    m = s.amax(-1, keepdim=True)
    m_safe = torch.where(m == _NEG_INF, 0.0, m)
    p = torch.exp(s - m_safe)
    l = p.sum(-1, keepdim=True)
    out = torch.matmul(p, v.to(p.dtype)) / torch.where(l == 0, 1.0, l)
    lse = torch.where(l == 0, _NEG_INF, m_safe + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def flash_attn_bwd_plain(q, k, v, out, lse, do, causal, sm_scale, q_off=0,
                         k_off=0):
    """Plain PyTorch FlashAttention-2 backward against the forward's
    (out, lse): ``p = exp(s - lse)``, ``delta = rowsum(dO * O)``,
    ``dS = p (dO V^T - delta) scale``. Returns (dq, dk, dv) at the inputs'
    dtypes."""
    delta = (do.to(_acc(q)) * out.to(_acc(q))).sum(-1)
    return _grads(q, k, v, lse, do, delta, causal, sm_scale, q_off, k_off)


def _grads(q, k, v, lse, do, delta, causal, sm_scale, q_off, k_off):
    """The backward's body against given (lse, delta) [B, H, Sq]: B1's
    and B5's plain versions."""
    s = _scores(q, k, causal, sm_scale, q_off, k_off)
    a = s.dtype
    lse_safe = torch.where(lse == _NEG_INF, 0.0, lse.to(a))
    p = torch.exp(s - lse_safe[..., None])             # masked: exp(-inf) = 0
    dof = do.to(a)
    delta = delta.to(a)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.to(a).transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * sm_scale
    dq = torch.matmul(ds, k.to(a))
    dk = torch.matmul(ds.transpose(-1, -2), q.to(a))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(op, q, k, v):
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"{op}: q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} must be (B, H, S, D)")
    B, H, Sq, D = q.shape
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != D:
        raise ValueError(f"{op}: q{tuple(q.shape)} and k{tuple(k.shape)} "
                         "differ in B, H or D")
    if not 1 <= D <= _MAX_HEAD_DIM or B * H > 65535:
        raise ValueError(f"{op}: head_dim {D} (need 1..{_MAX_HEAD_DIM}), "
                         f"B*H {B * H} (need <= 65535)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{op}: dtypes q/k/v {q.dtype}/{k.dtype}/{v.dtype} "
                         f"(one of {_DTYPES})")
    return B * H, Sq, k.shape[2], D


def _geo(BH, Sq, Sk, D, causal, q_off, k_off, sm_scale, dtype):
    return (BH, Sq, Sk, D, int(bool(causal)), int(q_off), int(k_off),
            float(sm_scale), int(dtype == torch.bfloat16))


def flash_attn_fwd(q, k, v, causal, sm_scale, q_off=0, k_off=0):
    """Attention forward. q [B, H, Sq, D], k/v [B, H, Sk, D], f32 or bf16
    (one dtype), D <= 128, contiguous, one device. On CUDA tensors
    launches the kernel of the path ``_tc_path`` picks (module docstring;
    counted in ``flash_attn_fwd.launches`` and ``.tc_launches`` or
    ``.simt_launches``); on CPU tensors runs ``flash_attn_fwd_plain``.
    Returns (out [B, H, Sq, D] at q's dtype, lse [B, H, Sq] f32)."""
    dev = common_device("flash_attn_fwd", q, k, v)
    if dev.type == "cpu":
        return flash_attn_fwd_plain(q, k, v, causal, sm_scale, q_off, k_off)
    out, lse, tc = _launch_fwd("flash_attn_fwd", q, k, v, causal, sm_scale,
                               q_off, k_off, dev)
    _count(flash_attn_fwd, tc)
    return out, lse


def _launch_fwd(op, q, k, v, causal, sm_scale, q_off, k_off, dev):
    """One forward launch on ``dev`` (B1's, or B5's at a block's offsets):
    (out, lse, whether the tensor-core path ran)."""
    BH, Sq, Sk, D = _check(op, q, k, v)
    require_contiguous(op, q=q, k=k, v=v)
    tc = _tc_path(q.dtype, D)
    if tc:
        _require_tma_aligned(op, q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _entry(tc, q.dtype, "flash_fwd")(
            ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse),
            *_geo(BH, Sq, Sk, D, causal, q_off, k_off, sm_scale, q.dtype),
            stream_ptr(dev))
    check_launch(op, rc)
    return out, lse, tc


def flash_attn_bwd(q, k, v, out, lse, do, causal, sm_scale, q_off=0,
                   k_off=0):
    """Attention backward against the forward's (out, lse). Shapes and
    dtypes as ``flash_attn_fwd``; out and do like q; lse [B, H, Sq] f32.
    On CUDA tensors launches the two kernels of the path ``_tc_path``
    picks (counted once in ``flash_attn_bwd.launches`` and in
    ``.tc_launches`` or ``.simt_launches``); on CPU tensors runs
    ``flash_attn_bwd_plain``. Returns (dq, dk, dv)."""
    dev = common_device("flash_attn_bwd", q, k, v, out, lse, do)
    if dev.type == "cpu":
        return flash_attn_bwd_plain(q, k, v, out, lse, do, causal, sm_scale,
                                    q_off, k_off)
    BH, Sq, Sk, D = _check("flash_attn_bwd", q, k, v)
    if (out.shape != q.shape or do.shape != q.shape or out.dtype != q.dtype
            or do.dtype != q.dtype or lse.dtype != torch.float32
            or tuple(lse.shape) != tuple(q.shape[:3])):
        raise ValueError(
            f"flash_attn_bwd: out {out.dtype}{tuple(out.shape)}, do "
            f"{do.dtype}{tuple(do.shape)}, lse {lse.dtype}{tuple(lse.shape)} "
            f"for q {q.dtype}{tuple(q.shape)}")
    require_contiguous("flash_attn_bwd", q=q, k=k, v=v, out=out, lse=lse,
                       do=do)
    tc = _tc_path(q.dtype, D)
    if tc:
        _require_tma_aligned("flash_attn_bwd", q=q, k=k, v=v, out=out,
                             do=do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _entry(tc, q.dtype, "flash_bwd")(
            ptr(q), ptr(k), ptr(v), ptr(out), ptr(do), ptr(lse), ptr(delta),
            ptr(dq), ptr(dk), ptr(dv),
            *_geo(BH, Sq, Sk, D, causal, q_off, k_off, sm_scale, q.dtype),
            stream_ptr(dev))
    check_launch("flash_attn_bwd", rc)
    _count(flash_attn_bwd, tc)
    return dq, dk, dv


for _w in (flash_attn_fwd, flash_attn_bwd):
    _w.launches = _w.tc_launches = _w.simt_launches = 0


@torch.library.custom_op("paddle_tpu_torch::flash_attn", mutates_args=())
def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, scale: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """B1's forward as an operator: ``flash_attn_fwd(q, k, v, causal,
    scale)`` on ``(B, H, S, D)`` inputs, (out, lse). Differentiable in q,
    k and v (not through lse)."""
    return flash_attn_fwd(q, k, v, causal, scale)


@flash_attn.register_fake
def _flash_attn_fake(q, k, v, causal, scale):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:3], dtype=torch.float32))


@torch.library.custom_op("paddle_tpu_torch::flash_attn_grad",
                         mutates_args=())
def flash_attn_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    causal: bool, scale: float
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B1's backward as an operator: ``flash_attn_bwd``, (dq, dk, dv)."""
    return flash_attn_bwd(q, k, v, out, lse, do, causal, scale)


@flash_attn_grad.register_fake
def _flash_attn_grad_fake(q, k, v, out, lse, do, causal, scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_attn_setup(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.causal, ctx.scale = causal, scale


def _flash_attn_backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attn_grad(q, k, v, out, lse, dout.contiguous(),
                                 ctx.causal, ctx.scale)
    return dq, dk, dv, None, None


flash_attn.register_autograd(_flash_attn_backward,
                             setup_context=_flash_attn_setup)
