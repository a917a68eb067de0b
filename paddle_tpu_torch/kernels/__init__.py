"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel module holds: the wrapper (launches the CUDA kernel on CUDA
tensors, runs the plain version on CPU tensors, raises otherwise), the
plain version, and a launch counter (``<wrapper>.launches``, a plain int
that moves only where the wrapper launches its kernel). The CUDA sources
live in ``csrc/`` and build at first use (``_build.py``).
"""
from __future__ import annotations

import ctypes

import torch


def common_device(op: str, *tensors) -> torch.device:
    """The one device every tensor of a kernel call lies on; a mix
    raises (a CUDA tensor must never reach the plain version)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{op}: tensors on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {dev}")
    return dev


def require_contiguous(op: str, **tensors) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(op: str, rc: int) -> None:
    """Raise on the cudaError_t a kernel's C entry returned."""
    if rc != 0:
        raise RuntimeError(f"{op}: CUDA launch failed with cudaError_t {rc}")


# B5's public functions, as paddle_tpu/kernels/__init__.py exports them
# (imported last: the kernel modules import the helpers above)
from .flash_block import (compute_delta, flash_attention_lse,  # noqa: E402
                          flash_block_attention, flash_block_attention_bwd,
                          merge_lse_blocks)
