"""Sequence parallelism: ring attention and Ulysses (port of
paddle_tpu/distributed/sequence_parallel.py).

The sequence dimension is the mesh axis ``sp``. Both functions take and
return global ``[B, S, H, D]`` tensors, as paddle_tpu's do; inside, the
single-controller mesh (``mesh.py``) holds one shard of ``S / sp`` rows per
position, and the loops over positions below play the part of
``shard_map``'s one body per device:

- ``ring_attention``: q stays put; k/v blocks rotate around the ring
  (``_ppermute``), and each step attends this position's q to the block
  it holds at the block's global offset, so causal masking stays exact.
  Each step is one launch of the blockwise flash kernel (B5,
  ``kernels/flash_block.py``) returning (out, lse), merged exactly across
  steps; the backward is a second ring in which the dK/dV accumulators
  rotate with the blocks, each step one B5 backward against the global
  (lse, delta).
- ``ulysses_attention``: an all-to-all (``_all_to_all``) turns sequence
  shards into head groups over the full sequence, one B5 launch per
  position attends them, and a second all-to-all turns it back.

paddle_tpu runs its fused body only where the shard tiles its Pallas
kernel's 128-row blocks and falls back to an einsum body otherwise. B5 on
the card takes any shard length and offset (head_dim <= 128; a larger one
raises on the card), so the port runs it at every geometry and has no
einsum body. With no ``sp`` axis above 1 both functions are the
flash-attention kernels (B1) on one device.

The transport is two functions, ``_ppermute`` and ``_all_to_all``, tensor
copies between the positions' devices (nothing moves between positions
that share a device). The dispatch decision of the last call is
``last_ring_dispatch()``, with paddle_tpu's keys: its path is
``"kernel"`` with sp above 1 (paddle_tpu writes ``"pallas"`` or, at a
geometry its kernel does not tile, ``"xla"``) and ``"flash"`` without
(paddle_tpu's ``"plain"``).
"""
from __future__ import annotations

import math

import torch

from ..kernels import flash_block as _fb
from ..nn.functional.flash_attention import _flash
from . import mesh as mesh_mod

__all__ = ["ring_attention", "ulysses_attention", "last_ring_dispatch"]

# the most recent dispatch: {"path": "kernel"|"flash", "reason":
# str, "sl": int, "d": int, "op": "ring"|"ulysses"}
_last_dispatch = {}


def last_ring_dispatch() -> dict:
    """The most recent ring/Ulysses kernel-dispatch decision."""
    return dict(_last_dispatch)


# --------------------------------------------------------------- transport

def _ppermute(xs, devices):
    """One step around the ring: position ``(i + 1) % sp`` receives
    ``xs[i]`` on its device (``lax.ppermute`` with ``i -> i + 1``)."""
    sp = len(xs)
    return [xs[(j - 1) % sp].to(devices[j]) for j in range(sp)]


def _all_to_all(xs, split_dim, concat_dim, devices):
    """Position j receives chunk j (along ``split_dim``) of every
    position's tensor, concatenated in position order along
    ``concat_dim`` (``lax.all_to_all(..., tiled=True)``)."""
    sp = len(xs)
    return [torch.cat([x.chunk(sp, split_dim)[j].to(devices[j]) for x in xs],
                      dim=concat_dim) for j in range(sp)]


def _shard(x, dim, devices):
    """Contiguous shards of ``x`` along ``dim``, one per position."""
    return [c.contiguous().to(d)
            for c, d in zip(x.chunk(len(devices), dim), devices)]


def _gather(xs, dim, device):
    return torch.cat([x.to(device) for x in xs], dim=dim)


# ------------------------------------------------------------------ bodies

def _ring_fused_fwd(qs, ks, vs, devices, sl, scale, causal):
    """Forward ring over kernel-layout shards [B, H, sl, D]: sp steps of
    one B5 launch per position, merged via the LSE weights. Returns (out
    at q's dtype, lse f32) per position."""
    sp = len(devices)
    B, H, _, D = qs[0].shape
    acc = [torch.zeros(B, H, sl, D, device=d) for d in devices]
    lse = [torch.full((B, H, sl), -math.inf, device=d) for d in devices]
    for i in range(sp):
        # the next rotation is issued before this step's compute, so a
        # peer copy overlaps the kernels (as the XLA scheduler overlaps it)
        if i < sp - 1:
            k_nxt, v_nxt = _ppermute(ks, devices), _ppermute(vs, devices)
        for idx in range(sp):
            src = (idx - i) % sp
            o_i, l_i = _fb.flash_block_fwd(qs[idx], ks[idx], vs[idx],
                                           idx * sl, src * sl, causal, scale)
            # each block's out is cast up from q's dtype before the merge
            acc[idx], lse[idx] = _fb.merge_lse_blocks(acc[idx], lse[idx],
                                                      o_i.float(), l_i)
        if i < sp - 1:
            ks, vs = k_nxt, v_nxt
    return [a.to(q.dtype) for a, q in zip(acc, qs)], lse


def _ring_fused_bwd(qs, ks, vs, outs, lses, dos, devices, sl, scale,
                    causal):
    """Backward ring: k/v blocks and their f32 gradient accumulators
    rotate together; each step adds this position's B5 block backward
    (against the global lse and one hoisted delta) to the dK/dV it holds,
    then rotates them, so after sp rotations every accumulator is home.
    dQ accumulates in place."""
    sp = len(devices)
    deltas = [_fb.compute_delta(o, do) for o, do in zip(outs, dos)]
    dq = [torch.zeros(q.shape, device=d) for q, d in zip(qs, devices)]
    dk = [torch.zeros(k.shape, device=d) for k, d in zip(ks, devices)]
    dv = [torch.zeros(v.shape, device=d) for v, d in zip(vs, devices)]
    for i in range(sp):
        if i < sp - 1:
            k_nxt, v_nxt = _ppermute(ks, devices), _ppermute(vs, devices)
        for idx in range(sp):
            src = (idx - i) % sp
            dq_i, dk_i, dv_i = _fb.flash_block_bwd(
                qs[idx], ks[idx], vs[idx], idx * sl, src * sl, lses[idx],
                dos[idx], deltas[idx], causal, scale)
            dq[idx].add_(dq_i)
            dk[idx].add_(dk_i)
            dv[idx].add_(dv_i)
        dk, dv = _ppermute(dk, devices), _ppermute(dv, devices)
        if i < sp - 1:
            ks, vs = k_nxt, v_nxt
    dt = qs[0].dtype                     # the kernel takes one dtype
    return tuple([g.to(dt) for g in acc] for acc in (dq, dk, dv))


class _RingFused(torch.autograd.Function):
    """The fused ring on global [B, S, H, D] tensors: shards in the kernel
    layout (B, H, sl, D), the forward and backward rings, the result
    gathered on the input's device (paddle_tpu's ``_ring_fused`` with its
    custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, devices, scale, causal):
        sl = q.shape[1] // len(devices)
        qs, ks, vs = (_shard(t.transpose(1, 2), 2, devices)
                      for t in (q, k, v))
        outs, lses = _ring_fused_fwd(qs, ks, vs, devices, sl, scale, causal)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.meta = (devices, sl, scale, causal, q.device)
        return _gather(outs, 2, q.device).transpose(1, 2)

    @staticmethod
    def backward(ctx, dout):
        devices, sl, scale, causal, home = ctx.meta
        sp = len(devices)
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (list(saved[i * sp:(i + 1) * sp])
                                  for i in range(5))
        dos = _shard(dout.transpose(1, 2), 2, devices)
        grads = _ring_fused_bwd(qs, ks, vs, outs, lses, dos, devices, sl,
                                scale, causal)
        return tuple(_gather(g, 2, home).transpose(1, 2)
                     for g in grads) + (None, None, None)




def _sp_devices():
    """(sp degree, the sp positions' devices or None)."""
    sp = mesh_mod.mesh_axis_size("sp")
    return sp, (mesh_mod.get_mesh().axis_devices("sp") if sp > 1 else None)


def ring_attention(q, k, v, causal: bool = False, scale: float = None):
    """Exact attention over sp-sharded sequences.

    q/k/v: global [B, S, H, D] tensors; S is split over the mesh's "sp"
    axis. The flash-attention kernels (B1) when sp == 1. Returns [B, S, H,
    D] on q's device."""
    sp, devices = _sp_devices()
    S, D = q.shape[1], q.shape[-1]
    scale = scale or 1.0 / math.sqrt(D)
    if sp <= 1:
        _last_dispatch.update(path="flash", sl=S, d=D, op="ring",
                              reason="sp<=1: no ring, single-device flash "
                              "attention")
        return _flash(q, k, v, causal, scale)
    if S % sp:
        raise ValueError(f"sequence {S} not divisible by sp={sp}")
    sl = S // sp
    _last_dispatch.update(path="kernel", sl=sl, d=D, op="ring",
                          reason="B5 ring")
    return _RingFused.apply(q, k, v, tuple(devices), float(scale),
                            bool(causal))


def _ulysses_body(qs, ks, vs, devices, scale, causal):
    """Shards [B, S/sp, H, D] -> all-to-all -> [B, S, H/sp, D] -> one B5
    launch per position -> all-to-all back (DeepSpeed-Ulysses)."""
    qf, kf, vf = (_all_to_all(xs, 2, 1, devices) for xs in (qs, ks, vs))
    outs = []
    for q, k, v in zip(qf, kf, vf):
        o, _ = _fb.flash_attention_lse(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, sm_scale=scale)
        outs.append(o.transpose(1, 2))
    return _all_to_all(outs, 1, 2, devices)


def ulysses_attention(q, k, v, causal: bool = False, scale: float = None):
    """Sequence-parallel attention via head<->sequence all-to-all.
    Requires num_heads % sp == 0. q/k/v: global [B, S, H, D]."""
    sp, devices = _sp_devices()
    D, H, S = q.shape[-1], q.shape[2], q.shape[1]
    scale = scale or 1.0 / math.sqrt(D)
    if sp <= 1:
        return ring_attention(q, k, v, causal=causal, scale=scale)
    if H % sp:
        raise ValueError(f"num_heads {H} not divisible by sp={sp}")
    if S % sp:
        raise ValueError(f"sequence {S} not divisible by sp={sp}")
    # after the all-to-all the local attention runs over the FULL sequence
    _last_dispatch.update(path="kernel", sl=S, d=D, op="ulysses",
                          reason="B5 on the full sequence")
    qs, ks, vs = (_shard(t, 1, devices) for t in (q, k, v))
    return _gather(_ulysses_body(qs, ks, vs, devices, float(scale), causal),
                   1, q.device)
