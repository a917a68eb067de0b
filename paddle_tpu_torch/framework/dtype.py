"""dtype names (port of paddle_tpu/framework/dtype.py's ``convert_dtype``):
paddle's and numpy's dtype names to torch dtypes and back."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_dtype", "dtype_name"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
           "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}
_ALIASES = {"bf16": "bfloat16", "fp16": "float16", "fp32": "float32",
            "fp64": "float64"}


def convert_dtype(dtype) -> torch.dtype:
    """A torch dtype from a paddle/numpy dtype name, a numpy dtype or a
    torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, type) and issubclass(dtype, np.generic) or \
            isinstance(dtype, np.dtype):
        dtype = np.dtype(dtype).name
    name = str(dtype).removeprefix("paddle.").removeprefix("torch.")
    name = _ALIASES.get(name, name)
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")
