"""Distributed parallelism (port of paddle_tpu/distributed/): the
single-controller device mesh, sequence-parallel attention, activation
recomputation and ``resilience``'s retry schedule and fault injection."""
from .mesh import (AXIS_ORDER, Mesh, get_mesh, init_mesh, mesh_axis_size,
                   set_mesh, use_mesh)
from . import resilience
from .recompute import recompute, recompute_sequential
from .resilience import (FaultInjected, FaultInjector, RetryPolicy,
                         with_retries)
from .sequence_parallel import (last_ring_dispatch, ring_attention,
                                ulysses_attention)

__all__ = ["AXIS_ORDER", "Mesh", "init_mesh", "get_mesh", "set_mesh",
           "use_mesh", "mesh_axis_size", "ring_attention",
           "ulysses_attention", "last_ring_dispatch", "resilience",
           "RetryPolicy", "with_retries", "FaultInjector", "FaultInjected",
           "recompute", "recompute_sequential"]
