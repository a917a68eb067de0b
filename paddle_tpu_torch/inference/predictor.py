"""The inference predictor (port of paddle_tpu/inference/predictor.py:
``Config``, ``Tensor``, ``Predictor``, ``create_predictor``,
``PredictorPool``, ``DataType``, ``PrecisionType``).

A ``Predictor`` runs a ``jit.save`` artifact: the program and its weights
are loaded onto the predictor's device, the card by default
(``Config.enable_use_gpu(.., device_id)`` picks ``cuda:device_id``,
``Config.disable_gpu()`` the CPU), and ``run()`` calls the program on the
inputs copied in through the handles. Input names are ``x0, x1, ...``,
output names ``out0, out1, ...`` (the program's outputs, flattened).
``copy_to_cpu`` returns numpy arrays; a bf16 output comes back as float32
(exact), since numpy has no bfloat16.

``Config.enable_continuous_batching(model=...)`` makes ``create_predictor``
return a ``GenerationPredictor`` over a ``ContinuousBatchingEngine`` on the
live model's device, as paddle_tpu's does.

Not ported (ROADMAP.md): ``Config.enable_int8`` (the int8 predictor)
raises. The reference's other GPU/TensorRT/MKLDNN knobs are accepted
no-ops.
"""
from __future__ import annotations

import os
from enum import Enum
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..jit.api import read_program

__all__ = ["Config", "Predictor", "create_predictor", "Tensor", "DataType",
           "PrecisionType", "PredictorPool", "get_version",
           "get_num_bytes_of_data_type"]


class Config:
    """paddle_infer.Config: where the model is and which device runs it."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        if prog_file and prog_file.endswith(".pdmodel"):
            prog_file = prog_file[: -len(".pdmodel")]
        self._model_prefix = prog_file
        self._params_file = params_file
        self._device = "gpu"
        self._device_id = 0
        self._engine_opts: Optional[Dict[str, object]] = None

    def enable_continuous_batching(self, model=None, slots=None,
                                   max_len=None, cache_dtype="bfloat16",
                                   prefill_buckets=None, tick_tokens=None,
                                   max_queue=None, do_sample=False,
                                   temperature=1.0, top_k=0, top_p=1.0):
        """Serve generate() traffic through the continuous-batching
        engine: ``create_predictor`` then returns a
        ``GenerationPredictor``. ``model`` is the live causal LM (the
        decode loop cannot be rebuilt from a saved program); the engine
        runs on its device."""
        self._engine_opts = {
            "model": model, "slots": slots, "max_len": max_len,
            "cache_dtype": cache_dtype,
            "prefill_buckets": prefill_buckets,
            "tick_tokens": tick_tokens, "max_queue": max_queue,
            "do_sample": do_sample, "temperature": temperature,
            "top_k": top_k, "top_p": top_p,
        }

    # -- model location --------------------------------------------------
    def set_model(self, prog_file: str, params_file: Optional[str] = None):
        if prog_file.endswith(".pdmodel"):
            prog_file = prog_file[: -len(".pdmodel")]
        self._model_prefix = prog_file
        self._params_file = params_file

    def prog_file(self):
        return (self._model_prefix or "") + ".pdmodel"

    def params_file(self):
        return self._params_file or (self._model_prefix or "") + ".pdiparams"

    def model_dir(self):
        return os.path.dirname(self._model_prefix or "")

    # -- device ----------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        """Run on ``cuda:device_id`` (``memory_pool_init_size_mb`` is
        accepted and ignored: PyTorch's caching allocator grows on
        demand)."""
        self._device = "gpu"
        self._device_id = device_id

    def enable_tpu(self, device_id: int = 0):
        """paddle_tpu's accelerator switch: here the card
        ``cuda:device_id``, as ``enable_use_gpu``."""
        self.enable_use_gpu(device_id=device_id)

    def disable_gpu(self):
        """Run on the CPU: the explicit CPU request."""
        self._device = "cpu"

    def use_gpu(self):
        return self._device == "gpu"

    def device(self) -> torch.device:
        """The predictor's device (raises when the card is asked for and
        there is none)."""
        if self._device == "cpu":
            return resolve_device("cpu")
        return resolve_device(f"cuda:{self._device_id}")

    def enable_int8(self):
        raise NotImplementedError(
            "Config.enable_int8 (the int8 predictor) is not ported yet — "
            "see ROADMAP.md")

    # -- accepted no-op knobs -------------------------------------------
    def enable_tensorrt_engine(self, *a, **k):
        pass

    def enable_mkldnn(self):
        pass

    def switch_ir_optim(self, x=True):
        pass

    def enable_memory_optim(self):
        pass

    def switch_use_feed_fetch_ops(self, x=False):
        pass

    def switch_specify_input_names(self, x=True):
        pass

    def set_cpu_math_library_num_threads(self, n):
        pass

    def enable_profile(self):
        pass

    def disable_glog_info(self):
        pass

    def summary(self) -> str:
        dev = "cpu" if self._device == "cpu" else f"cuda:{self._device_id}"
        return f"Config(model={self._model_prefix!r}, device={dev})"


class Tensor:
    """paddle_infer.Tensor: the input/output handle. ``copy_from_cpu``
    puts a numpy array on the predictor's device; ``copy_to_cpu`` brings
    an output back (a host sync)."""

    def __init__(self, name: str, owner: "Predictor"):
        self.name = name
        self._owner = owner
        self._value: Optional[torch.Tensor] = None

    def reshape(self, shape):
        pass  # shapes flow from the copied array

    def copy_from_cpu(self, data: np.ndarray):
        self._value = torch.from_numpy(np.ascontiguousarray(data)).to(
            self._owner.device)

    def copy_to_cpu(self) -> np.ndarray:
        out = self._owner._outputs.get(self.name)
        if out is None:
            raise RuntimeError("run() has not produced this output yet")
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.cpu().numpy()

    def shape(self):
        v = self._owner._outputs.get(self.name, self._value)
        return list(v.shape) if v is not None else []


class Predictor:
    """paddle_infer.Predictor over a ``jit.save`` artifact."""

    def __init__(self, config: Config):
        self.config = config
        self.device = config.device()
        self._program, self._state, self._input_spec = read_program(
            config.prog_file(), config.params_file(), self.device)
        n_inputs = len(self._input_spec) if self._input_spec else 1
        self._input_names = [f"x{i}" for i in range(n_inputs)]
        self._inputs: Dict[str, Tensor] = {
            n: Tensor(n, self) for n in self._input_names}
        self._outputs: Dict[str, torch.Tensor] = {}
        self._output_names: List[str] = []

    # -- handles ---------------------------------------------------------
    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_dtype(self, name: str) -> Optional[str]:
        """The declared dtype of an input (from the saved InputSpec)."""
        if name not in self._input_names:
            raise KeyError(f"unknown input {name!r}; expected "
                           f"{self._input_names}")
        if self._input_spec is None:
            return None
        return str(self._input_spec[self._input_names.index(name)][1])

    def get_input_handle(self, name: str) -> Tensor:
        return self._inputs[name]

    def get_output_names(self) -> List[str]:
        return list(self._output_names) or ["out0"]

    def get_output_handle(self, name: str) -> Tensor:
        return Tensor(name, self)

    # -- execution -------------------------------------------------------
    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """Run the program on the handles' inputs (``inputs``, when given,
        are copied in first; then the outputs are returned as numpy
        arrays, else True)."""
        if inputs is not None:
            for name, arr in zip(self._input_names, inputs):
                self._inputs[name].copy_from_cpu(np.asarray(arr))
        args = []
        for name in self._input_names:
            v = self._inputs[name]._value
            if v is None:
                raise RuntimeError(
                    f"input {name!r} not set; use get_input_handle("
                    f"{name!r}).copy_from_cpu(...)")
            args.append(v)
        with torch.no_grad():
            out = self._program(self._state, *args)
        leaves = list(out) if isinstance(out, (tuple, list)) else [out]
        self._output_names = [f"out{i}" for i in range(len(leaves))]
        self._outputs = dict(zip(self._output_names, leaves))
        if inputs is not None:
            return [self.get_output_handle(n).copy_to_cpu()
                    for n in self._output_names]
        return True

    def clear_intermediate_tensor(self):
        self._outputs.clear()


def create_predictor(config: Config):
    """paddle_infer.create_predictor; with
    ``Config.enable_continuous_batching`` the engine-backed
    ``GenerationPredictor`` instead of a ``Predictor``."""
    if getattr(config, "_engine_opts", None):
        from .engine import create_engine_predictor
        return create_engine_predictor(config)
    return Predictor(config)


class DataType(Enum):
    """paddle_infer.DataType."""
    FLOAT32 = 0
    INT64 = 1
    INT32 = 2
    UINT8 = 3
    INT8 = 4
    FLOAT16 = 5
    BFLOAT16 = 6
    BOOL = 7


class PrecisionType(Enum):
    """paddle_infer.PrecisionType."""
    Float32 = 0
    Half = 1
    Int8 = 2
    Bfloat16 = 3


_DTYPE_BYTES = {DataType.FLOAT32: 4, DataType.INT64: 8, DataType.INT32: 4,
                DataType.UINT8: 1, DataType.INT8: 1, DataType.FLOAT16: 2,
                DataType.BFLOAT16: 2, DataType.BOOL: 1}


def get_num_bytes_of_data_type(dtype: "DataType") -> int:
    return _DTYPE_BYTES[DataType(dtype)]


def get_version() -> str:
    return f"paddle_tpu_torch inference (torch {torch.__version__})"


class PredictorPool:
    """paddle_infer.PredictorPool: ``size`` independent predictors over one
    Config."""

    def __init__(self, config: Config, size: int = 1):
        if size < 1:
            raise ValueError("PredictorPool size must be >= 1")
        self._predictors = [Predictor(config) for _ in range(size)]

    def retrive(self, idx: int) -> Predictor:   # the reference's spelling
        return self._predictors[idx]

    retrieve = retrive

    def __len__(self):
        return len(self._predictors)
