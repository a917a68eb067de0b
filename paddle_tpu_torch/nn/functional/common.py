"""Common functionals (port of paddle_tpu/nn/functional/common.py:
``dropout``)."""
from __future__ import annotations

import torch

from ...framework.random import keep_mask

__all__ = ["dropout"]

_MODES = ("upscale_in_train", "downscale_in_infer")


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """paddle's ``dropout``: zero each element with probability ``p``.
    ``axis`` (an int or a list) draws one keep decision per index of those
    axes, shared along the others. ``upscale_in_train`` scales the kept
    elements by ``1 / (1 - p)``; ``downscale_in_infer`` keeps them as
    they are. With ``training=False`` or ``p == 0`` it returns ``x``
    itself, as paddle_tpu returns its input unchanged (in either mode).
    The mask is drawn from the port's generator for x's device
    (``framework.random``). ``name`` is ignored, as paddle_tpu ignores
    it."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout: p {p} outside [0, 1]")
    if mode not in _MODES:
        raise ValueError(f"dropout: mode {mode!r} (one of {_MODES})")
    if not training or p == 0.0:
        return x
    if axis is None:
        shape = x.shape
    else:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        keep_axes = {a % x.ndim for a in axes}
        shape = [n if i in keep_axes else 1 for i, n in enumerate(x.shape)]
    if p == 1.0:
        return x * 0                    # every element dropped
    keep = keep_mask(shape, p, x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0)
    return torch.where(keep, x, 0.0)
