"""Random state (port of paddle_tpu/framework/random.py: ``Generator``,
``seed``, ``default_generator``, ``get_rng_state`` / ``set_rng_state``).

paddle_tpu keeps one JAX PRNG key and splits a fresh subkey off it for
each random op. The port keeps one explicit ``torch.Generator`` per device
instead, each created at first use and seeded with the generator's seed,
so a run's random ops draw the same numbers on every rerun with that
seed. Dropout (``nn.functional.dropout`` and the attention-dropout branch)
draws from these generators, never from torch's global RNG. The bits are
not JAX's threefry bits, by design (ROADMAP.md §C): tests compare
distributions, or rebuild the port's own mask from a reseeded generator.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["Generator", "seed", "default_generator", "get_rng_state",
           "set_rng_state", "keep_mask"]


class Generator:
    """One seed, and one ``torch.Generator`` per device seeded with it."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self.manual_seed(seed)

    def manual_seed(self, seed: int):
        """Reseed: every device's generator restarts from ``seed`` at its
        next use."""
        with self._lock:
            self._seed = int(seed)
            self._gens: dict[torch.device, torch.Generator] = {}
        return self

    def initial_seed(self) -> int:
        return self._seed

    def get(self, device) -> torch.Generator:
        """The generator of ``device`` (created and seeded at first use)."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        with self._lock:
            gen = self._gens.get(dev)
            if gen is None:
                gen = torch.Generator(device=dev).manual_seed(self._seed)
                self._gens[dev] = gen
            return gen

    def get_state(self):
        """``{"seed": s, "states": {device str: ByteTensor}}``."""
        with self._lock:
            return {"seed": self._seed,
                    "states": {str(d): g.get_state()
                               for d, g in self._gens.items()}}

    def set_state(self, state):
        """Restore what ``get_state`` returned."""
        self.manual_seed(state["seed"])
        for dev, st in state["states"].items():
            self.get(dev).set_state(st)


_default = Generator(0)


def default_generator() -> Generator:
    return _default


def seed(s: int) -> Generator:
    """``paddle.seed``: reseed the default generator on every device."""
    return _default.manual_seed(int(s))


def get_rng_state():
    return _default.get_state()


def set_rng_state(state):
    _default.set_state(state)


def keep_mask(shape, p: float, device) -> torch.Tensor:
    """A bool mask of ``shape`` on ``device``, True with probability
    ``1 - p`` (``jax.random.bernoulli(key, 1 - p, shape)``), drawn from
    the default generator's stream for that device."""
    u = torch.rand(tuple(shape), device=device,
                   generator=_default.get(device))
    return u < (1.0 - p)
