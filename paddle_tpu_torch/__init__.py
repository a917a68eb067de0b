"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

A second package beside ``paddle_tpu`` (the JAX reference). Module paths
mirror ``paddle_tpu/`` so each port module's counterpart is found by
name. The port imports ``torch``, ``numpy`` and the standard library
only — never ``jax`` and nothing under ``paddle_tpu``.

Every entry point runs on the CUDA card unless the caller passes
``device="cpu"`` or calls ``set_device("cpu")``, and every ``nn.Layer``
builds its parameters there; with no card and no explicit CPU request
it raises (``device.resolve_device``). Kernels that ``paddle_tpu``
wrote in Pallas for the TPU are hand-written CUDA C++ for ``sm_90a`` here
(``kernels/csrc``), built by ``nvcc`` at first use; on CPU tensors each
kernel wrapper runs its plain PyTorch version instead.

Covered today: serving — GPT (``models.gpt``) and Llama
(``models.llama``), ``generate`` greedy or sampled, slot, int8 slot and
paged KV caches, the continuous-batching engine (sampling, n-gram
speculation) and its HTTP server; training — the GPT and Llama steps:
``flash_attention`` and ``cross_entropy`` on their kernels, every
optimizer of paddle_tpu (with f32 master weights), the ``optimizer.lr``
schedulers, the ``nn.clip`` clips and ``jit.TrainStep`` with its
windows (``scan_steps``), ``warm``, ``skip_step`` and
``flush_accumulation``;
sequence parallelism — ``distributed.init_mesh({"sp": n})`` (a
single-controller mesh), ``ring_attention`` and ``ulysses_attention`` on
the blockwise flash kernels, which GPT's and Llama's attention take under
such a mesh; the serving tier's surface — streamed ``/generate``,
``/cancel``, ``/drain``, ``/metrics``, ``/admin/trace``, the engine's
warmup and the ``Config.enable_continuous_batching`` predictor — with
the observability package (``obs``: metrics registry, spans, flight
recorder) and the fault-injection half of ``distributed.resilience``.
"""
from .device import get_device, resolve_device, set_device
from .framework.random import seed
from .io import load, save
from . import inference, nn, obs  # noqa: E402  (paddle_tpu parity)

__all__ = ["resolve_device", "set_device", "get_device", "seed", "save",
           "load", "inference", "nn", "obs"]
