"""Scan-stacked layers (port of paddle_tpu/models/scanned.py:
``ScannedStack``): a homogeneous block stack held as ONE set of stacked
parameters ``[num_layers, ...]``, one for each of the template block's
parameters.

In paddle_tpu the stack is one ``lax.scan``, so XLA compiles the block
body once whatever the depth. PyTorch compiles nothing, so here the
stack is a weight layout and the forward a Python loop over the layers:
each layer's slices of the stacked leaves are swapped into a template
block (built on the meta device, no memory) by
``torch.func.functional_call``, and its ordinary ``forward`` runs. The
slices come from ONE ``torch.unbind`` per stacked leaf a call, whose
backward stacks the layers' gradients once (``W[i]`` a layer would fill a
zero tensor the size of the whole stack for each layer's gradient).
Under ``recompute`` in training each layer runs through the port's
``recompute`` (``distributed/recompute.py``), as paddle_tpu puts
``jax.checkpoint`` on the scan body.

Parameter names are paddle_tpu's: the block's names with ``.`` written
``__`` (``attn__qkv__weight``), so ``convert.load_paddle_tpu_params``
copies a scanned JAX model by name. The initialisation rule is
paddle_tpu's: leaves whose per-layer rank is >= 2 are drawn from N(0,
initializer_range), rank-1 ``*.weight`` leaves (norm scales) are ones,
everything else (biases) zeros. A stack built on a real device draws
from ``framework.random``'s generator, as a layer built alone does; the
models build theirs on the meta device and draw with their own generator
by the same rule (``stacked_init_kinds``).

Decode (``forward_cached``) takes stacked caches: ``(k_stack,
v_stack)`` ``[L, B, M, nkv, hd]`` tensors, int8 dicts of stacked planes,
or stacked paged pools ``[L, NP, PS, nkv, hd]`` with one block table and
one set of write gates (``bt``, ``live``, ``wlen``) shared by every
layer. Each layer sees ``leaf[i]``, a contiguous view, so the B4 step and
the B3 writes work on it in place and no copy is made.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from ..distributed.recompute import _checkpoint, resolve_checkpoint_policy
from ..nn.layer.common import _draw
from ..nn.layer_base import Layer

__all__ = ["ScannedStack", "stacked_init_kinds"]

# per-call page metadata the engine attaches to a paged pool dict: shared
# by all layers, never stacked
_SHARED_KEYS = ("bt", "live", "wlen")


def _layer_view(cache, i):
    """Layer ``i``'s view of one stacked cache half."""
    if isinstance(cache, dict):
        return {k: (v if k in _SHARED_KEYS else v[i])
                for k, v in cache.items()}
    return cache[i]


class ScannedStack(Layer):
    """``num_layers`` copies of ``block_factory()`` as stacked-leaf
    parameters (see the module docstring). Blocks with buffers are
    rejected, as paddle_tpu rejects them; stochastic blocks (dropout > 0)
    are rejected by the caller (``reject_dropout``), as there."""

    def __init__(self, block_factory, num_layers: int,
                 initializer_range: float, recompute: bool = False,
                 recompute_policy: str = "full"):
        super().__init__()
        self.num_layers = int(num_layers)
        self.recompute = recompute
        # resolve eagerly: a misspelt policy fails at construction
        self._ckpt_policy = resolve_checkpoint_policy(recompute_policy)
        with torch.device("meta"):
            tmpl = block_factory()
        if list(tmpl.named_buffers()):
            raise NotImplementedError(
                "scan_layers with buffered blocks: buffers are not "
                "stacked across layers (same restriction as "
                "PipelineLayer body blocks)")
        # a plain list: the template gives structure and forward only, and
        # is not a submodule (no parameters of its own in the tree)
        self._template = [tmpl]
        self._names = []
        std = float(initializer_range)
        for name, p in tmpl.named_parameters():
            sp = nn.Parameter(torch.empty((self.num_layers, *p.shape)))
            self.register_parameter(self._mangle(name), sp)
            self._names.append(name)
            kind = self._kind(name, p.ndim)
            if kind == "normal":
                _draw(sp, lambda t, g: t.normal_(0.0, std, generator=g))
            else:
                _draw(sp, lambda t, g, v=float(kind == "ones"): t.fill_(v),
                      random=False)

    @staticmethod
    def _kind(name: str, rank: int) -> str:
        """paddle_tpu's rule for one per-layer leaf of ``rank``."""
        if rank >= 2:
            return "normal"
        return "ones" if name.endswith(".weight") else "zeros"

    @staticmethod
    def reject_dropout(p: float) -> None:
        """Caller-side guard, as paddle_tpu's (whose scan body is traced
        once, so every layer would reuse one dropout mask)."""
        if p:
            raise NotImplementedError(
                "scan_layers requires dropout=0.0: the scan body is "
                "traced once, so every layer would reuse the same "
                "dropout mask")

    @staticmethod
    def _mangle(name: str) -> str:
        return name.replace(".", "__")

    def _leaves(self):
        return [self._parameters[self._mangle(n)] for n in self._names]

    def init_kinds(self) -> dict:
        """{id(stacked leaf): "normal" | "ones" | "zeros"} by the rule."""
        return {id(self._parameters[self._mangle(n)]):
                self._kind(n, self._parameters[self._mangle(n)].ndim - 1)
                for n in self._names}

    def load_from_blocks(self, blocks) -> None:
        """Stack the parameters of an unrolled block list into this stack
        (checkpoint interop), each cast to the stacked leaf's dtype."""
        blocks = list(blocks)
        if len(blocks) != self.num_layers:
            raise ValueError(
                f"load_from_blocks: got {len(blocks)} blocks for a "
                f"num_layers={self.num_layers} model")
        per_layer = [dict(b.named_parameters()) for b in blocks]
        with torch.no_grad():
            for name in self._names:
                vals = [d[name] for d in per_layer]
                if any(v.is_meta for v in vals):
                    raise ValueError(
                        "load_from_blocks: source blocks hold meta "
                        "parameters — materialize them first")
                target = self._parameters[self._mangle(name)]
                target.copy_(torch.stack([v.detach().to(target.device)
                                          for v in vals]))

    def _run_layer(self, x, *rest):
        """One layer: ``rest`` is the block's extra arguments followed by
        this layer's slices of the stacked leaves."""
        n = len(self._names)
        extra, psl = rest[:len(rest) - n], rest[len(rest) - n:]
        return functional_call(self._template[0],
                               dict(zip(self._names, psl)), (x, *extra))

    def forward(self, x, *extra):
        """Apply the stack to ``x``; ``extra`` are layer-invariant
        arguments handed to every block (an encoder's attention mask)."""
        self._template[0].train(self.training)
        slices = [torch.unbind(leaf, 0) for leaf in self._leaves()]
        recompute = self.recompute and self.training
        for i in range(self.num_layers):
            psl = [s[i] for s in slices]
            if recompute:
                x = _checkpoint(self._run_layer, x, *extra, *psl,
                                policy=self._ckpt_policy)
            else:
                x = self._run_layer(x, *extra, *psl)
        return x

    def forward_cached(self, x, caches, pos):
        """Decode or prefill through stacked caches ``(k_stack,
        v_stack)``, written in place; returns ``(x, caches)``."""
        self._template[0].train(False)
        k_stack, v_stack = caches
        slices = [torch.unbind(leaf, 0) for leaf in self._leaves()]
        for i in range(self.num_layers):
            cache = (_layer_view(k_stack, i), _layer_view(v_stack, i))
            x, _ = self._run_layer(x, cache, pos, *[s[i] for s in slices])
        return x, caches


def stacked_init_kinds(model: nn.Module) -> dict:
    """{id(param): kind} for every stacked leaf of the ScannedStacks in
    ``model`` (their own initialisation rule; a model's draw loop applies
    it with the model's generator)."""
    kinds = {}
    for m in model.modules():
        if isinstance(m, ScannedStack):
            kinds.update(m.init_kinds())
    return kinds
