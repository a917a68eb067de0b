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

paddle_tpu's training step draws step n's randomness from ``fold_in(key,
n)``, so what a step draws depends on its step count alone. The port's
counterpart is ``Generator.folded(n)``: inside it every device's
generator is a fresh one seeded from (seed, n), and the generators of
before come back on exit. ``jit.TrainStep`` runs each step's forward and
backward inside ``folded(step_count)``.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["Generator", "seed", "default_generator", "get_rng_state",
           "set_rng_state", "keep_mask"]


class Generator:
    """One seed, and one ``torch.Generator`` per device seeded with it."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._fold = None          # the seed inside ``folded``
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
                gen = torch.Generator(device=dev).manual_seed(
                    self._seed if self._fold is None else self._fold)
                self._gens[dev] = gen
            return gen

    @contextlib.contextmanager
    def folded(self, data: int):
        """Inside: every device's generator is a fresh one seeded with
        ``_fold_seed(seed, data)`` (created at first use, as outside); on
        exit the generators of before come back, at the states they had.
        What is drawn inside depends on the seed and ``data`` alone, not
        on what was drawn before. One scope at a time (not nested)."""
        with self._lock:
            saved = self._gens, self._fold
            self._gens, self._fold = {}, _fold_seed(self._seed, data)
        try:
            yield self
        finally:
            with self._lock:
                self._gens, self._fold = saved

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


_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _fold_seed(seed: int, data: int) -> int:
    """A 63-bit seed from (``seed``, ``data``): splitmix64 of the mixed
    seed xor ``data``, so neighbouring ``data`` give unrelated seeds."""
    return _splitmix64(_splitmix64(int(seed) & _MASK64)
                       ^ (int(data) & _MASK64)) >> 1


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
