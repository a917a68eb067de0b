"""Global device mesh (port of paddle_tpu/distributed/mesh.py:39-112).

paddle_tpu installs one ``jax.sharding.Mesh`` whose named axes ("pp",
"dp", "sharding", "ep", "sp", "mp") carry every parallelism dimension, and
one program drives every device. The port's mesh is single-controller in
the same way: one process drives every shard, and the mesh holds an
explicit ``torch.device`` per position. A position may repeat a device:
``devices=["cuda:0"] * 4`` runs a 4-way ``sp`` ring on one card (every
shard on it, the rotations free), ``devices=["cpu"] * 4`` runs it on the
CPU (the counterpart of the JAX tests' virtual host devices), and the
first four cards put one shard on each, a rotation becoming a peer copy.

Only the ``sp`` axis may have a degree above 1 so far: data, tensor,
pipeline and expert parallelism come with the distributed-training and
tensor-parallel slices (ROADMAP.md), and raise ``NotImplementedError``
until then.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["AXIS_ORDER", "Mesh", "init_mesh", "get_mesh", "set_mesh",
           "use_mesh", "mesh_axis_size"]

# canonical axis order, outermost first (paddle_tpu's)
AXIS_ORDER = ("pp", "dp", "sharding", "ep", "sp", "mp")
_PORTED_AXES = ("sp",)

_global_mesh: Optional["Mesh"] = None
# thread-local override (``use_mesh``), as in paddle_tpu
_thread_mesh = threading.local()


class Mesh:
    """Named axes over an array of ``torch.device`` positions.

    ``devices`` is the position array, an object ndarray of
    ``torch.device`` with one dimension per axis; ``shape`` maps each axis
    name to its degree (``mesh.shape.get("sp", 1)`` as on a JAX mesh)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"device array of rank {devices.ndim} for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis`` at position 0 of every other axis, in
        axis order: the positions an ``axis``-sharded tensor's shards go
        to. An axis the mesh lacks has one position."""
        if axis not in self.shape:
            return [self.devices.flat[0]]
        first = tuple(slice(None) if a == axis else 0
                      for a in self.axis_names)
        return list(self.devices[first])


def init_mesh(degrees: Dict[str, int],
              devices: Optional[Sequence] = None) -> Mesh:
    """Create and install the global mesh.

    ``degrees``: e.g. ``{"sp": 4}``, each at least 1; the mesh has one
    position per product of the degrees. ``devices``: the positions
    (``torch.device`` or strings, repeats allowed), as many as that
    product; default the leading CUDA cards, and too few cards raise: the
    mesh never lands on the CPU or on one card unasked. Axes other than
    ``sp`` with a degree above 1 raise ``NotImplementedError``."""
    global _global_mesh
    if not degrees:
        raise ValueError("init_mesh: give the axis degrees, e.g. {'sp': 4}")
    for ax, d in degrees.items():
        if ax not in AXIS_ORDER:
            raise ValueError(f"unknown mesh axis {ax!r}; valid: {AXIS_ORDER}")
        if not isinstance(d, int) or d < 1:
            raise ValueError(f"mesh axis {ax!r}: degree {d!r} (need >= 1)")
        if d > 1 and ax not in _PORTED_AXES:
            raise NotImplementedError(
                f"mesh axis {ax!r} of degree {d}: only {_PORTED_AXES} is "
                "ported so far — see ROADMAP.md")
    total = math.prod(degrees.values())
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < total:
            raise RuntimeError(
                f"init_mesh: {degrees} needs {total} CUDA devices, have {n}; "
                f"pass devices= (e.g. ['cuda:0'] * {total}, or ['cpu'] * "
                f"{total} for a mesh on the CPU)")
        devices = [f"cuda:{i}" for i in range(total)]
    if len(devices) != total:
        raise ValueError(f"mesh degrees {degrees} use {total} devices, "
                         f"given {len(devices)}")
    axes = [ax for ax in AXIS_ORDER if ax in degrees]
    arr = np.empty(total, dtype=object)
    arr[:] = [resolve_device(d) for d in devices]
    _global_mesh = Mesh(arr.reshape([degrees[ax] for ax in axes]), axes)
    return _global_mesh


def set_mesh(mesh: Optional[Mesh]):
    global _global_mesh
    _global_mesh = mesh


def get_mesh() -> Optional[Mesh]:
    """The current mesh (a ``use_mesh`` override first), None without
    one: no default mesh is ever created."""
    override = getattr(_thread_mesh, "mesh", None)
    return override if override is not None else _global_mesh


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Thread-locally override the mesh ``get_mesh`` returns; re-entrant,
    restores the previous override on exit. The global mesh is
    untouched."""
    prev = getattr(_thread_mesh, "mesh", None)
    _thread_mesh.mesh = mesh
    try:
        yield mesh
    finally:
        _thread_mesh.mesh = prev


def mesh_axis_size(axis: str) -> int:
    """The degree of ``axis`` on the current mesh, 1 without one."""
    mesh = get_mesh()
    return mesh.shape.get(axis, 1) if mesh else 1
