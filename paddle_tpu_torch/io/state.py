"""``save`` / ``load`` (port of paddle_tpu/io/state.py), in paddle_tpu's
file format: a pickle of the nested dicts, lists and tuples, where each
tensor becomes ``{"__paddle_tpu_tensor__": "Parameter" | "Tensor",
"data": numpy array, "name": ..., "stop_gradient": ...}`` (the port
keeps paddle's ``name`` as a tensor's ``param_name``). So a state
dict written by ``paddle_tpu.save`` loads here and the reverse, and
unpickling either needs no module of either package.

numpy has no bfloat16 and the port does not depend on ``ml_dtypes``: a
bf16 tensor is written as its exact f32 widening with ``"dtype":
"bfloat16"`` beside it (paddle_tpu, which reads only the four keys above,
loads the same values in f32), and read back bit for bit. A file in which
paddle_tpu pickled an ``ml_dtypes`` bfloat16 array loads where
``ml_dtypes`` is installed and raises ``BFloat16FileError`` where it is
not.
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch
from torch import nn

__all__ = ["save", "load", "BFloat16FileError"]

_TENSOR_TAG = "__paddle_tpu_tensor__"


class BFloat16FileError(pickle.UnpicklingError):
    """The file holds ``ml_dtypes`` bfloat16 arrays (written by paddle_tpu)
    and this machine has no ``ml_dtypes`` to read them: save them in
    float32 there, or load where ``ml_dtypes`` is installed."""


def _pack(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        packed = {_TENSOR_TAG: "Parameter" if isinstance(obj, nn.Parameter)
                  else "Tensor",
                  "name": getattr(obj, "param_name", None),
                  "stop_gradient": not obj.requires_grad}
        if t.dtype == torch.bfloat16:
            packed["data"] = t.float().numpy()
            packed["dtype"] = "bfloat16"
        else:
            packed["data"] = t.numpy()
        return packed
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _bf16_from_widened(data) -> torch.Tensor:
    """The bf16 tensor whose exact f32 widening is ``data``: the high
    16 bits of each f32 word (bit for bit, NaN payloads included)."""
    bits = torch.from_numpy(np.ascontiguousarray(data, np.float32)
                            .view(np.int32) >> 16).to(torch.int16)
    return bits.view(torch.bfloat16)


def _to_torch(data) -> torch.Tensor:
    arr = np.asarray(data)
    if arr.dtype.name == "bfloat16":            # an ml_dtypes array
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _unpack(obj: Any, return_numpy: bool) -> Any:
    if isinstance(obj, dict):
        if _TENSOR_TAG in obj:
            if return_numpy:
                return obj["data"]
            if obj.get("dtype") == "bfloat16":
                t = _bf16_from_widened(obj["data"])
            else:
                t = _to_torch(obj["data"])
            grad = not obj["stop_gradient"] and (t.is_floating_point()
                                                 or t.is_complex())
            if obj[_TENSOR_TAG] == "Parameter":
                t = nn.Parameter(t, requires_grad=grad)
            else:
                t.requires_grad_(grad)
            if obj["name"] is not None:
                t.param_name = obj["name"]
            return t
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy) for v in obj)
    return obj


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except ModuleNotFoundError as e:
            if module.split(".")[0] == "ml_dtypes":
                raise BFloat16FileError(
                    f"{name} from {module}: this file holds ml_dtypes "
                    "bfloat16 arrays and ml_dtypes is not installed") from e
            raise


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` (a state dict, an optimizer's, nested containers of
    tensors, or plain Python values) to ``path`` in paddle_tpu's format
    (module docstring); the directory is made. ``configs`` are accepted
    and ignored, as paddle_tpu ignores them."""
    if not isinstance(path, (str, os.PathLike)):
        raise TypeError("save: pass a str path")
    path = os.fspath(path)
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    """The object ``save`` (or ``paddle_tpu.save``) wrote: tensors as CPU
    torch tensors (Parameters where a Parameter was saved), or, with
    ``return_numpy``, as the numpy arrays in the file (a port-written
    bf16 tensor as its f32 widening). Unpickling runs what the file
    says: load only files you trust."""
    with open(os.fspath(path), "rb") as f:
        obj = _Unpickler(f).load()
    return _unpack(obj, return_numpy)
