"""Activation recomputation (port of paddle_tpu/distributed/recompute.py:
``recompute``, ``recompute_sequential``, ``resolve_checkpoint_policy``).

paddle_tpu wraps the function in ``jax.checkpoint``; the port wraps it in
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the
forward keeps only the boundary's inputs, and the backward runs the
function again to rebuild what it needs.

Policies, as paddle_tpu names them: ``"full"`` (or None) saves nothing
and recomputes the whole function; ``"dots"`` saves the outputs of the
matrix products (``aten.mm`` / ``addmm`` / ``bmm``, through selective
checkpointing) and recomputes the rest, as JAX's
``dots_with_no_batch_dims_saveable`` does. A callable is taken as a
selective-checkpointing policy ``policy(ctx, op, *args, **kwargs) ->
CheckpointPolicy``.

Random state: ``torch.utils.checkpoint`` restores only torch's own
generators, and the port's dropout draws from ``framework.random``'s
generator of each device. ``_checkpoint`` saves those generators' states
at the boundary and sets them back for the recompute (restoring the
current ones afterwards), so a recomputed dropout draws the forward's
mask. paddle_tpu's keys are values and need nothing of the kind.
"""
from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as _ckpt

from ..framework import random as _random

__all__ = ["recompute", "recompute_sequential", "resolve_checkpoint_policy"]

_SAVED_BY_DOTS = frozenset(
    (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
     torch.ops.aten.bmm.default))


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the matrix products' outputs, recompute everything else."""
    if op in _SAVED_BY_DOTS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


_POLICIES = {"full": None, "dots": _dots_policy}


def resolve_checkpoint_policy(policy):
    """A policy name ("full" / "dots"), a selective-checkpointing policy
    callable, or None -> None (save nothing) or the policy callable.
    An unknown name raises ValueError."""
    if policy is None or callable(policy):
        return policy
    try:
        return _POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"recompute policy {policy!r} not in {sorted(_POLICIES)} "
            "(or pass a selective-checkpointing policy callable)") from None


def _tensor_devices(args, kwargs):
    return {a.device for a in (*args, *kwargs.values())
            if isinstance(a, torch.Tensor)}


def _checkpoint(fn, *args, policy=None, **kwargs):
    """``fn(*args, **kwargs)`` under ``torch.utils.checkpoint`` with the
    resolved ``policy``; the port's dropout generators of the arguments'
    devices are put back to their boundary state for the recompute."""
    gen = _random.default_generator()
    saved = {d: gen.get(d).get_state() for d in _tensor_devices(args, kwargs)}
    calls = [0]

    def run(*a, **kw):
        calls[0] += 1
        if calls[0] == 1:                 # the forward
            return fn(*a, **kw)
        now = {d: gen.get(d).get_state() for d in saved}
        for d, st in saved.items():
            gen.get(d).set_state(st)
        try:
            return fn(*a, **kw)
        finally:
            for d, st in now.items():
                gen.get(d).set_state(st)

    context_fn = (_ckpt.noop_context_fn if policy is None else
                  functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                    policy))
    return _ckpt.checkpoint(run, *args, use_reentrant=False,
                            context_fn=context_fn, **kwargs)


def recompute(function, *args, **kwargs):
    """Parity: paddle.distributed.fleet.utils.recompute.

    ``function`` is a module (or a module's bound method); its forward
    runs again in the backward instead of keeping its activations.
    ``use_reentrant`` and ``preserve_rng_state`` are accepted and ignored,
    as paddle_tpu ignores them (the recompute is always non-reentrant and
    draws the forward's dropout masks). ``policy=`` ("full" / "dots" or a
    selective-checkpointing callable) selects what is saved."""
    kwargs.pop("use_reentrant", None)
    kwargs.pop("preserve_rng_state", None)
    policy = resolve_checkpoint_policy(kwargs.pop("policy", None))
    layer = function
    if not isinstance(layer, torch.nn.Module):
        layer = getattr(function, "__self__", None)
        if not isinstance(layer, torch.nn.Module):
            raise TypeError(
                "recompute requires a Layer (parameters must be visible to "
                "the remat boundary); wrap plain functions in a Layer")
    return _checkpoint(function, *args, policy=policy, **kwargs)


def recompute_sequential(ctx, functions, *args):
    """Parity: paddle.incubate.distributed.fleet.recompute_sequential —
    checkpoint the modules of ``functions`` in ``ctx["segments"]``
    segments of equal length."""
    segments = int(ctx.get("segments", 1)) if isinstance(ctx, dict) else 1
    layers = list(functions)
    per = max(len(layers) // max(segments, 1), 1)
    out = args
    for i in range(0, len(layers), per):
        seg = layers[i:i + per]
        block = seg[0] if len(seg) == 1 else torch.nn.Sequential(*seg)
        out = (recompute(block, *out),)
    return out[0]
