"""Gradient clipping (port of paddle_tpu/nn/clip.py:ClipGradByGlobalNorm)."""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    """Scale every gradient by ``min(1, clip_norm / max(||g||, 1e-12))``,
    where ``||g||`` is the f32 global L2 norm over all of them."""

    def __init__(self, clip_norm=1.0, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def clip_raw(self, grads):
        """The clipped grads, a new list (each at its input dtype). The
        norm stays a device tensor: no host sync."""
        if not grads:
            return []
        sq = [torch.sum(torch.square(g.float())) for g in grads]
        total = sq[0]
        for s in sq[1:]:
            total = total + s
        gn = torch.sqrt(total)
        scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-12),
                            max=1.0)
        return [(g.float() * scale).to(g.dtype) for g in grads]
