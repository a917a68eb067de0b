"""Gradient clipping (port of paddle_tpu/nn/clip.py: ``ClipGradBase``,
``ClipGradByGlobalNorm``, ``ClipGradByNorm``, ``ClipGradByValue`` and
``clip_grads_raw``).

Each clip has two faces, as paddle_tpu's: ``clip_raw(grads)`` over a
list of gradient tensors, which the optimizers' update calls on the
gradients of the parameters whose ``need_clip`` is not False, and
``__call__(params_grads)`` over ``(param, grad)`` pairs. No clip reads a
norm on the host: the norms and scales stay device tensors, so a clip
adds no synchronisation to a step.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "clip_grads_raw"]


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError

    def clip_raw(self, grads):
        """The clipped gradients of the list ``grads``, a new list."""
        raise NotImplementedError


def _scale(norm, clip_norm):
    """``min(1, clip_norm / max(norm, 1e-12))``, a device tensor."""
    return torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by ``min(1, clip_norm / max(||g||, 1e-12))``,
    where ``||g||`` is the f32 global L2 norm over all of them. In
    ``__call__``, a parameter with ``need_clip = False`` stays out of the
    norm and keeps its gradient."""

    def __init__(self, clip_norm=1.0, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        subject = [i for i, (p, _) in enumerate(params_grads)
                   if getattr(p, "need_clip", True)]
        if not subject:
            return params_grads
        clipped = self.clip_raw([params_grads[i][1] for i in subject])
        out = list(params_grads)
        for i, c in zip(subject, clipped):
            out[i] = (params_grads[i][0], c)
        return out

    def clip_raw(self, grads):
        """The clipped grads, a new list (each at its input dtype)."""
        if not grads:
            return []
        sq = [torch.sum(torch.square(g.float())) for g in grads]
        total = sq[0]
        for s in sq[1:]:
            total = total + s
        scale = _scale(torch.sqrt(total), self.clip_norm)
        return [(g.float() * scale).to(g.dtype) for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient on its own by ``min(1, clip_norm /
    max(||g||, 1e-12))`` (the norm at the gradient's dtype). As
    paddle_tpu's, ``__call__`` clips every pair; the optimizers' update
    leaves ``need_clip = False`` parameters out, as for every clip."""

    def __init__(self, clip_norm=1.0):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        return [(p, c) for (p, _), c in zip(
            params_grads, self.clip_raw([g for _, g in params_grads]))]

    def clip_raw(self, grads):
        return [g * _scale(torch.linalg.vector_norm(g.reshape(-1)),
                           self.clip_norm) for g in grads]


class ClipGradByValue(ClipGradBase):
    """Clamp every gradient element into ``[min, max]`` (``min`` defaults
    to ``-max``). ``__call__`` clips every pair, as paddle_tpu's."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return [(p, c) for (p, _), c in zip(
            params_grads, self.clip_raw([g for _, g in params_grads]))]

    def clip_raw(self, grads):
        return [torch.clamp(g, self.min, self.max) for g in grads]


def clip_grads_raw(grads, clip):
    """``clip.clip_raw(grads)``, or ``grads`` when ``clip`` is None."""
    if clip is None:
        return grads
    return clip.clip_raw(grads)
