"""Loss functionals (port of paddle_tpu/nn/functional/loss.py:
``cross_entropy`` and ``softmax_with_cross_entropy``).

The hard-label softmax cross-entropy (no class weights, no label
smoothing, softmax over the last axis) goes through the fused
cross-entropy kernels (B2, ``kernels/fused_ce.py``) forward and backward
via ``_FusedSoftmaxCE``: the path paddle_tpu takes with
``PADDLE_TPU_FUSED_CE``. The port has no unfused chain to fall back on,
so this path always takes the kernels. Soft labels, class weights, label
smoothing and other axes run as plain tensor code, as they run as XLA
code in paddle_tpu. The loss is computed in f32 whatever the logits'
dtype.
"""
from __future__ import annotations

import torch

from ...kernels.fused_ce import ce_bwd, ce_fwd

__all__ = ["cross_entropy", "softmax_with_cross_entropy"]


class _FusedSoftmaxCE(torch.autograd.Function):
    """Per-row ``logsumexp(lg) - lg[idx]`` over ``[N, V]`` logits (f32
    result); backward ``(softmax - onehot) * g`` at the logits' dtype.
    ``idx`` is int32, already clipped to ``[0, V)``."""

    @staticmethod
    def forward(ctx, lg, idx):
        per, lse = ce_fwd(lg, idx)
        ctx.save_for_backward(lg, idx, lse)
        return per

    @staticmethod
    def backward(ctx, g):
        lg, idx, lse = ctx.saved_tensors
        return ce_bwd(lg, idx, lse, g.float().contiguous()), None


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


def _fused_hard_label(logits, idx, ignore_index, reduction):
    V = logits.shape[-1]
    idx_c = idx.clamp(0, V - 1).to(torch.int32).reshape(-1)
    per = _FusedSoftmaxCE.apply(logits.reshape(-1, V).contiguous(),
                                idx_c.contiguous()).reshape(idx.shape)
    mask = idx != ignore_index
    per = torch.where(mask, per, 0.0)
    if reduction == "mean":
        return per.sum() / mask.sum().clamp(min=1)
    return _reduce(per, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """paddle's ``cross_entropy``: ``input`` logits ``[..., C]`` (class
    axis ``axis``); ``label`` integer indices ``[...]`` or ``[..., 1]``, or
    float soft labels of ``input``'s shape. Rows whose label equals
    ``ignore_index`` contribute 0 and leave the mean's denominator (at
    least 1). Returns an f32 tensor."""
    label = torch.as_tensor(label, device=input.device)
    axis = axis % input.ndim
    soft = soft_label or (label.shape == input.shape
                          and label.is_floating_point())
    if (use_softmax and not soft and weight is None
            and label_smoothing == 0.0 and axis == input.ndim - 1):
        idx = label[..., 0] if label.ndim == input.ndim else label
        return _fused_hard_label(input, idx, ignore_index, reduction)
    logits = input.float().movedim(axis, -1)
    logp = (torch.log_softmax(logits, dim=-1) if use_softmax
            else torch.log(torch.clamp(logits, min=1e-30)))
    C = logp.shape[-1]
    if soft:
        tgt = label.float().movedim(axis, -1)
        if label_smoothing > 0:
            tgt = (1 - label_smoothing) * tgt + label_smoothing / C
        return _reduce(-(tgt * logp).sum(-1), reduction)
    idx = label.movedim(axis, -1)[..., 0] if label.ndim == input.ndim \
        else label
    idx_c = idx.clamp(0, C - 1).to(torch.int64)
    per = -logp.gather(-1, idx_c[..., None])[..., 0]
    if label_smoothing > 0:
        per = (1 - label_smoothing) * per \
            + label_smoothing * -logp.mean(-1)
    mask = idx != ignore_index
    per = torch.where(mask, per, 0.0)
    if weight is not None:
        wt = torch.as_tensor(weight, device=input.device).float()[idx_c]
        per = per * wt
    if reduction == "mean":
        denom = ((wt * mask).sum().clamp(min=1e-12) if weight is not None
                 else mask.sum().clamp(min=1))
        return per.sum() / denom
    return _reduce(per, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-row loss with the class axis kept as size 1 (paddle's
    ``softmax_with_cross_entropy``); with ``return_softmax`` also the
    softmax of ``logits`` over ``axis``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss
