"""``nn.utils`` (port of paddle_tpu/nn/utils.py): flattening parameters
to one vector and back, the in-place gradient clips, and the weight and
spectral reparameterisations.

``weight_norm`` and ``spectral_norm`` re-derive the weight from the
registered parameters in a forward pre-hook with differentiable tensor
operations, so autograd carries the gradient to ``weight_g`` /
``weight_v`` (or ``weight_orig``), as paddle_tpu's tape does; the derived
weight is a plain attribute of the layer, not a parameter.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["parameters_to_vector", "vector_to_parameters", "clip_grad_norm_",
           "clip_grad_value_", "weight_norm", "remove_weight_norm",
           "spectral_norm"]


def parameters_to_vector(parameters, name=None):
    """The parameters' values flattened and concatenated, in order."""
    return torch.cat([p.detach().reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive slices of ``vec`` into ``parameters``, in order."""
    offset = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            p.copy_(vec[offset:offset + n].reshape(p.shape))
            offset += n


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the gradients in place by ``min(1, max_norm / (total +
    1e-6))``, ``total`` their ``norm_type`` norm over all of them (the
    largest |g| for inf); returns ``total``. ``error_if_nonfinite`` is
    accepted and ignored, as paddle_tpu ignores it."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([p.grad.abs().max() for p in params]).max()
    else:
        total = sum(p.grad.abs().pow(norm_type).sum()
                    for p in params) ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    with torch.no_grad():
        for p in params:
            p.grad = p.grad * scale
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp every gradient into ``[-clip_value, clip_value]`` in
    place."""
    with torch.no_grad():
        for p in parameters:
            if p.grad is not None:
                p.grad = p.grad.clamp(-clip_value, clip_value)


def _norm_except(v, dim):
    """||v|| over every axis but ``dim`` (kept), or over all of v."""
    if dim is None:
        return torch.sqrt(torch.sum(v * v))
    axes = [i for i in range(v.ndim) if i != dim]
    return torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))


def weight_norm(layer, name="weight", dim=0):
    """Reparameterise ``layer.<name>`` as a direction ``<name>_v`` and a
    magnitude ``<name>_g``: ``w = g * v / ||v||`` (the norm over every axis
    but ``dim``, or over all with ``dim=None``)."""
    w = getattr(layer, name)
    if not isinstance(w, nn.Parameter):
        raise ValueError(f"{name!r} is not a Parameter of {layer}")
    with torch.no_grad():
        g0 = _norm_except(w, dim)
    v = nn.Parameter(w.detach().clone())
    g = nn.Parameter(g0.clone())
    del layer._parameters[name]
    layer.register_parameter(name + "_v", v)
    layer.register_parameter(name + "_g", g)

    def _recompute(lyr, inputs=()):
        vv = getattr(lyr, name + "_v")
        gg = getattr(lyr, name + "_g")
        object.__setattr__(lyr, name, gg * (vv / _norm_except(vv, dim)))

    handle = layer.register_forward_pre_hook(_recompute)
    layer.__dict__.setdefault("_wn_state", {})[name] = (handle, dim)
    _recompute(layer)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold ``g * v / ||v||`` back into one plain parameter ``<name>``."""
    state = layer.__dict__.get("_wn_state", {})
    if name not in state:
        raise ValueError(f"no weight norm registered on {name!r}")
    handle, dim = state.pop(name)
    handle.remove()
    with torch.no_grad():
        v = getattr(layer, name + "_v")
        g = getattr(layer, name + "_g")
        w = g * (v / _norm_except(v, dim))
    del layer._parameters[name + "_v"]
    del layer._parameters[name + "_g"]
    layer.__dict__.pop(name, None)
    layer.register_parameter(name, nn.Parameter(w))
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Divide ``layer.<name>`` by its largest singular value, estimated
    by power iteration on the non-persistable buffers ``<name>_u`` /
    ``<name>_v`` (updated without gradient), the weight kept as
    ``<name>_orig``. ``dim=None``: the output-channel axis, 1 for a Linear
    (``[in, out]``) or a transposed conv, else 0. ``u`` and ``v`` start
    from ``numpy.random.default_rng(0)``'s normals, as paddle_tpu's."""
    w = getattr(layer, name)
    if not isinstance(w, nn.Parameter):
        raise ValueError(f"{name!r} is not a Parameter of {layer}")
    if dim is None:
        cls = type(layer).__name__
        dim = 1 if (cls == "Linear" or "Transpose" in cls) else 0
    shape = list(w.shape)
    h = shape[dim]
    perm = [dim] + [i for i in range(len(shape)) if i != dim]
    rng = np.random.default_rng(0)
    u0 = torch.tensor(rng.standard_normal(h), dtype=torch.float32,
                      device=w.device)
    v0 = torch.tensor(rng.standard_normal(int(np.prod(shape)) // h),
                      dtype=torch.float32, device=w.device)
    del layer._parameters[name]
    layer.register_parameter(name + "_orig", w)
    nn.Module.register_buffer(layer, name + "_u", u0, persistent=False)
    nn.Module.register_buffer(layer, name + "_v", v0, persistent=False)

    def _recompute(lyr, inputs=()):
        w_orig = getattr(lyr, name + "_orig")
        w_mat = w_orig.permute(perm).reshape(h, -1)
        with torch.no_grad():
            u = getattr(lyr, name + "_u")
            vv = getattr(lyr, name + "_v")
            mat = w_mat.detach().to(u.dtype)
            for _ in range(n_power_iterations):
                vv = mat.T @ u
                vv = vv / torch.clamp(torch.linalg.norm(vv), min=eps)
                u = mat @ vv
                u = u / torch.clamp(torch.linalg.norm(u), min=eps)
            getattr(lyr, name + "_u").copy_(u)
            getattr(lyr, name + "_v").copy_(vv)
        # sigma through differentiable operations: the gradient reaches
        # <name>_orig
        sigma = torch.sum(u * (w_mat @ vv.to(w_mat.dtype)))
        object.__setattr__(lyr, name, w_orig / sigma)

    handle = layer.register_forward_pre_hook(_recompute)
    layer.__dict__.setdefault("_sn_state", {})[name] = handle
    _recompute(layer)
    return layer
