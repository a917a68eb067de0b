"""Device resolution: the card by default, the CPU only on request.

Counterpart of ``paddle_tpu/device/`` for the port. There is no silent
fallback: an entry point called without ``device=`` on a machine with no
CUDA card raises instead of running on the CPU. ``set_device`` is
paddle's way to ask for the CPU (or another card) once for every entry
point and every layer built afterwards.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "set_device", "get_device"]

_current = None


def resolve_device(device=None) -> torch.device:
    """``None`` -> the device ``set_device`` chose, else the current CUDA
    device (raises when there is none); ``"cpu"`` / ``"cuda"`` /
    ``"cuda:N"`` / a ``torch.device`` -> that device, checked to exist."""
    if device is None:
        if _current is not None:
            return _current
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: paddle_tpu_torch runs on the card by "
                "default; pass device='cpu' (or set_device('cpu')) to run "
                "on the CPU")
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


def set_device(device):
    """paddle's ``set_device``: ``"gpu"`` / ``"gpu:N"`` (``"tpu"``,
    ``"xpu"`` and ``"cuda"`` name the card too), ``"cpu"`` or a
    ``torch.device`` becomes the device of every entry point called
    without ``device=`` and of every layer built afterwards; ``None``
    goes back to the default, the card. Returns the device."""
    global _current
    if isinstance(device, str):
        kind, _, idx = device.partition(":")
        kind = {"gpu": "cuda", "tpu": "cuda", "xpu": "cuda"}.get(kind, kind)
        device = f"{kind}:{idx}" if idx else kind
    _current = None if device is None else resolve_device(device)
    return _current


def get_device():
    """The device of ``resolve_device()`` as paddle names it:
    ``"gpu:N"`` or ``"cpu:0"``."""
    dev = resolve_device()
    return f"gpu:{dev.index}" if dev.type == "cuda" else "cpu:0"


def param_device() -> torch.device:
    """Where a layer builds its parameters: torch's default device where
    the caller set one (``with torch.device(...)``, as the models build on
    the meta device, or ``torch.set_default_device``), else
    ``resolve_device()``: the card, or raise."""
    from torch.overrides import _get_current_function_mode_stack
    from torch.utils._device import DeviceContext
    if any(isinstance(m, DeviceContext)
           for m in _get_current_function_mode_stack()) or \
            getattr(torch._GLOBAL_DEVICE_CONTEXT, "device_context",
                    None) is not None:
        return torch.get_default_device()
    return resolve_device()
