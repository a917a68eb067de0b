"""Device resolution: the card by default, the CPU only on request.

Counterpart of ``paddle_tpu/device/`` for the port. There is no silent
fallback: an entry point called without ``device=`` on a machine with no
CUDA card raises instead of running on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises when there is none);
    ``"cpu"`` / ``"cuda"`` / ``"cuda:N"`` / a ``torch.device`` -> that
    device, checked to exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: paddle_tpu_torch runs on the card by "
                "default; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: cuda or cpu")
    return dev
