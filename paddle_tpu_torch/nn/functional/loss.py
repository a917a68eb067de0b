"""Loss functionals (port of paddle_tpu/nn/functional/loss.py:
``cross_entropy``, ``softmax_with_cross_entropy`` and
``fused_linear_cross_entropy``).

The hard-label softmax cross-entropy (no class weights, no label
smoothing, softmax over the last axis) goes through the fused
cross-entropy kernels (B2, ``kernels/fused_ce.py``) forward and backward
via ``_FusedSoftmaxCE``: the path paddle_tpu takes with
``PADDLE_TPU_FUSED_CE``. The port has no unfused chain to fall back on,
so this path always takes the kernels. Soft labels, class weights, label
smoothing and other axes run as plain tensor code, as they run as XLA
code in paddle_tpu. The loss is computed in f32 whatever the logits'
dtype.

``fused_linear_cross_entropy`` is the LM head and the loss in one, in
chunks of tokens, so the ``[N, V]`` logits never exist whole: each
chunk's f32 logits go through the B2 kernels forward and, recomputed,
backward (``_FusedLinearCE``), where paddle_tpu runs a rematerialised
``lax.map`` of a plain log-sum-exp.
"""
from __future__ import annotations

import torch

from ...kernels.fused_ce import ce_bwd, ce_fwd

__all__ = ["cross_entropy", "softmax_with_cross_entropy",
           "fused_linear_cross_entropy"]


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


def _mm_f32(a, b):
    """``a @ b`` with an f32 result from f32 products of the inputs, as
    paddle_tpu's ``preferred_element_type=jnp.float32``: on the card a
    bf16 GEMM with an f32 output (bf16 tensor cores, f32 accumulation);
    elsewhere the product of the inputs cast to f32 (exact products of
    bf16 values)."""
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == a.dtype:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _FusedLinearCE(torch.autograd.Function):
    """Mean cross-entropy of ``hidden [N, H] @ W`` over the rows whose
    label is not ignored, in chunks of ``C`` rows; the tail chunk is
    padded to ``C`` rows of zeros with ignored labels, as paddle_tpu pads
    it, so every chunk has one shape.

    Forward: for each chunk the f32 logits ``[C, V]``, then B2 forward
    (``ce_fwd``: loss and log-sum-exp per row); only ``hidden``, ``W``,
    the labels and the per-row lse are saved. Backward: for each chunk the
    logits again, B2 backward (``ce_bwd``) for dlogits scaled by ``g /
    count`` (0 on ignored rows), ``dhidden = dlogits @ W`` and ``dW +=
    dlogits^T @ hidden`` into one f32 accumulator, cast once at the end.
    For a bf16 ``W``, B2 writes the dlogits of the f32 logits rounded to
    bf16 for the two backward GEMMs (each with an f32 output)."""

    @staticmethod
    def _rows(hidden, s, C):
        """Rows ``[s, s + C)`` of ``hidden``, zero-padded to ``C``."""
        h = hidden[s:s + C]
        if h.shape[0] < C:
            h = torch.cat([h, h.new_zeros((C - h.shape[0], h.shape[1]))])
        return h

    @staticmethod
    def forward(ctx, hidden, weight, label, C, ignore_index, tw):
        N = hidden.shape[0]
        V = weight.shape[0] if tw else weight.shape[1]
        wm = weight.t() if tw else weight                 # [H, V]
        padded = -(-N // C) * C
        valid = torch.zeros(padded, dtype=torch.bool, device=hidden.device)
        valid[:N] = label != ignore_index
        idx = torch.zeros(padded, dtype=torch.int32, device=hidden.device)
        idx[:N] = label.clamp(0, V - 1)
        lse = torch.empty(padded, dtype=torch.float32, device=hidden.device)
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for s in range(0, N, C):
            lg = _mm_f32(_FusedLinearCE._rows(hidden, s, C), wm)  # [C, V]
            per, lse[s:s + C] = ce_fwd(lg, idx[s:s + C])
            total += torch.where(valid[s:s + C], per, 0.0).sum()
            del lg
        count = valid.sum().clamp(min=1)
        ctx.save_for_backward(hidden, weight, idx, valid, lse, count)
        ctx.chunk, ctx.tw = C, tw
        return total / count

    @staticmethod
    def backward(ctx, g):
        hidden, weight, idx, valid, lse, count = ctx.saved_tensors
        C, tw = ctx.chunk, ctx.tw
        N = hidden.shape[0]
        wm = weight.t() if tw else weight                 # [H, V]
        scale = torch.where(valid, g.float() / count, 0.0)
        dhidden = torch.empty_like(hidden)
        dwm = torch.zeros(wm.shape, dtype=torch.float32,
                          device=weight.device)           # [H, V] f32
        for s in range(0, N, C):
            h = _FusedLinearCE._rows(hidden, s, C)
            lg = _mm_f32(h, wm)
            dlg = ce_bwd(lg, idx[s:s + C], lse[s:s + C], scale[s:s + C],
                         out_dtype=weight.dtype)          # [C, V]
            del lg
            n = min(C, N - s)
            dhidden[s:s + n] = _mm_f32(dlg[:n], wm.t()).to(hidden.dtype)
            dwm += _mm_f32(h.t(), dlg)
            del dlg
        dw = (dwm.t() if tw else dwm).to(weight.dtype)
        return dhidden, dw, None, None, None, None


def fused_linear_cross_entropy(hidden, weight, label, chunk_size=512,
                               ignore_index=-100, transpose_weight=None,
                               name=None):
    """LM-head projection and softmax cross-entropy without the whole
    ``[N, V]`` logits: tokens stream through the projection in chunks of
    ``chunk_size`` (the tail chunk shorter), and the backward computes
    each chunk's logits again, so the extra memory is one chunk's
    ``[chunk_size, V]`` f32 logits instead of ``[N, V]``.

    hidden ``[N, H]`` or ``[B, S, H]``; label int ``[N]`` or ``[B, S]``;
    weight ``[V, H]`` (the tied embedding's layout) or ``[H, V]``
    (``transpose_weight=False``). ``transpose_weight=None`` infers the
    layout from the shapes, and a square weight, which is ambiguous,
    raises. The mean is over the tokens whose label is not
    ``ignore_index`` (at least 1). ``name`` is ignored. Returns an f32
    scalar."""
    H = hidden.shape[-1]
    tw = transpose_weight
    if tw is None:
        if weight.shape[0] == weight.shape[1]:
            raise ValueError(
                "fused_linear_cross_entropy: square weight is "
                "ambiguous — pass transpose_weight explicitly")
        tw = weight.shape[-1] == H          # [V, H] -> project with W.T
    label = torch.as_tensor(label, device=hidden.device)
    hf = hidden.reshape(-1, H)
    lf = label.reshape(-1)
    if lf.shape[0] != hf.shape[0]:
        raise ValueError(f"fused_linear_cross_entropy: {lf.shape[0]} labels "
                         f"for {hf.shape[0]} tokens")
    chunk = max(1, min(int(chunk_size), hf.shape[0]))
    return _FusedLinearCE.apply(hf, weight, lf, chunk, int(ignore_index),
                                bool(tw))
