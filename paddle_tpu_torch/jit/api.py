"""``jit.save`` / ``jit.load`` (port of paddle_tpu/jit/api.py: ``InputSpec``
:37, ``save`` :291, ``TranslatedLayer`` :415, ``load`` :439).

paddle_tpu serialises the traced program as StableHLO (``jax.export``);
the port exports it with ``torch.export``. The program takes the weights
as its first argument, a ``{name: tensor}`` dict, as paddle_tpu's
``exported.call(state, *inputs)`` does, so the program file holds no
weights. Files:

- ``<path>.pdmodel``: the ``torch.export.save`` archive of the program;
- ``<path>.pdiparams``: a pickle ``{"state": {name: ndarray},
  "input_spec": [(shape strs, dtype str)], "dtypes": {name: "bfloat16"}}``,
  paddle_tpu's layout plus ``dtypes``: numpy has no bfloat16, so a bf16
  tensor is stored as its 16-bit pattern (int16) and named there.

A ``None`` or ``-1`` dim of an ``InputSpec`` becomes a dynamic dim of the
program (``torch.export.Dim.DYNAMIC``). ``torch.export`` fixes a dim whose
example size is 0 or 1, so the example has size 2 there where paddle_tpu's
has 1; the loaded program takes size 1 all the same. The program holds the
device of its export in its constants (``arange``, ``zeros_like``);
``load`` and the predictor move it to their device
(``torch.export.passes.move_to_device_pass``), so a program saved on the
CPU serves on the card.

The formats are the port's own: the port does not read paddle_tpu's
StableHLO artifacts, and paddle_tpu does not read the port's archives.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..device import resolve_device
from ..framework.dtype import convert_dtype, dtype_name

__all__ = ["InputSpec", "save", "load", "TranslatedLayer"]

class InputSpec:
    """paddle.static.InputSpec: the declared shape and dtype of an input;
    ``None`` or ``-1`` marks a dynamic dim."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = list(shape)
        self.dtype = dtype
        self.name = name
        self.stop_gradient = stop_gradient

    def _example(self, device) -> torch.Tensor:
        """Zeros of the spec's shape, a dynamic dim at size 2 (0 and 1 are
        fixed by torch.export)."""
        shape = [2 if (d is None or d < 0) else d for d in self.shape]
        return torch.zeros(shape, dtype=convert_dtype(self.dtype),
                           device=device)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype!r}, "
                f"name={self.name!r})")


class _Program(torch.nn.Module):
    """``forward(state, *inputs)``: ``layer`` called with ``state`` as its
    parameters and buffers. ``layer`` is not a registered submodule, so
    the exported program lifts none of its weights."""

    def __init__(self, layer):
        super().__init__()
        object.__setattr__(self, "layer", layer)

    def forward(self, state, *inputs):
        return torch.func.functional_call(self.layer, state, inputs)


def save(layer, path, input_spec=None, platforms=None, **config):
    """Export ``layer`` (an ``nn.Module``) for serving: writes
    ``<path>.pdmodel`` and ``<path>.pdiparams`` (module docstring). The
    layer is exported in eval mode and put back in training mode after
    when it was in it. ``input_spec``: one ``InputSpec`` per positional
    input. ``platforms`` and ``config`` are accepted and ignored:
    paddle_tpu lowers per platform, while the port's program is moved to
    its device when it is loaded."""
    if not isinstance(layer, torch.nn.Module):
        raise TypeError("jit.save expects an nn.Module")
    if input_spec is None or not all(isinstance(s, InputSpec)
                                     for s in input_spec):
        raise ValueError("jit.save requires input_spec: an InputSpec (shape "
                         "and dtype) per input")
    state = dict(layer.named_parameters())
    state.update(layer.named_buffers())
    state = {n: t.detach() for n, t in state.items()}
    device = next(iter(state.values())).device if state else \
        torch.device("cpu")
    examples, dims, saved_spec, n_dyn = [], [], [], 0
    for spec in input_spec:
        dyn, strs = {}, []
        for i, d in enumerate(spec.shape):
            if d is None or d < 0:
                dyn[i] = torch.export.Dim.DYNAMIC
                strs.append(f"_dyn{n_dyn}")
                n_dyn += 1
            else:
                strs.append(str(d))
        examples.append(spec._example(device))
        dims.append(dyn or None)
        saved_spec.append((strs, dtype_name(examples[-1].dtype)))
    was_training = layer.training
    layer.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(
                _Program(layer), (state, *examples),
                dynamic_shapes=({n: None for n in state}, tuple(dims)))
    finally:
        if was_training:
            layer.train()
    # the archive would also keep the example inputs, the weights among them
    program.example_inputs = None
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    with open(path + ".pdmodel", "wb") as f:     # not named .pt2
        torch.export.save(program, f)
    arrays, dtypes = {}, {}
    for n, t in state.items():
        t = t.cpu()
        if t.dtype == torch.bfloat16:
            dtypes[n] = "bfloat16"
            t = t.view(torch.int16)
        arrays[n] = t.numpy()
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump({"state": arrays, "input_spec": saved_spec,
                     "dtypes": dtypes}, f)


def read_program(prog_file, params_file, device):
    """(program module on ``device``, state on ``device``, saved input
    spec) of a ``save`` artifact: the shared half of ``load`` and
    ``inference.Predictor``. The params file is a pickle this package
    wrote: load only artifacts you trust."""
    from torch.export.passes import move_to_device_pass
    with open(prog_file, "rb") as f:
        program = move_to_device_pass(torch.export.load(f), str(device))
    with open(params_file, "rb") as f:
        meta = pickle.load(f)
    bf16 = meta.get("dtypes", {})
    state = {}
    for n, a in meta["state"].items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        if bf16.get(n) == "bfloat16":
            t = t.view(torch.bfloat16)
        state[n] = t.to(device)
    return program.module(), state, meta.get("input_spec") or None


class TranslatedLayer:
    """A loaded serving program (paddle's TranslatedLayer): call it like
    the layer; inference only."""

    def __init__(self, program, state, device):
        self._program = program
        self._state = state
        self.device = device
        self.training = False

    def __call__(self, *args):
        inputs = [torch.as_tensor(a).to(self.device) for a in args]
        with torch.no_grad():
            return self._program(self._state, *inputs)

    forward = __call__

    def eval(self):
        return self

    def train(self, mode=True):
        raise RuntimeError("TranslatedLayer is an inference program")


def load(path, device=None, **config) -> TranslatedLayer:
    """paddle.jit.load: the program saved at ``path`` on ``device`` (the
    card by default; ``device="cpu"`` for the CPU)."""
    dev = resolve_device(device)
    program, state, _ = read_program(path + ".pdmodel", path + ".pdiparams",
                                     dev)
    return TranslatedLayer(program, state, dev)
