"""The efficiency formula (port of paddle_tpu/obs/efficiency.py): model
FLOPs or modeled bytes over measured wall time, as a fraction of one
card's peak.

* training: ``mfu(train_step_flops(params, tokens), seconds)`` — the
  nominal 6 * params * tokens accounting (recompute and attention's
  O(L*H*S^2) term excluded).
* serving: ``model_bandwidth_eff(modeled_tick_bytes(kind, geometry),
  seconds)`` — modeled HBM bytes of one engine dispatch per measured
  second as a fraction of the card's bandwidth. The engine exports it
  per tick as the ``ptpu_engine_tick_model_eff`` gauge and in
  ``stats()["tick_model_eff"]``.

``modeled_tick_bytes`` keeps paddle_tpu's three analytic formulas
(``paddle_tpu/analysis/hlo_cost.py``: the dense decode tick, the paged
tick, the speculative verify dispatch) unchanged, so the gauge prices the
same bytes for the same geometry in both packages. They count the passes
paddle_tpu's compiled programs make over the cache; the port's kernels
make fewer (B4 reads a slot's cache once), so on the card the gauge is a
yardstick across the two packages, not the port's own byte count.

The denominator is a card of ``CHIP_SPECS``, keyed by
``torch.cuda.get_device_name()``; ``PADDLE_TPU_EFF_CHIP`` picks an entry
by that name. The table holds the card the port is built for, the H100
SXM 80 GB (NVIDIA's data sheet: 3.35 TB/s HBM, 989 TFLOP/s dense bf16);
a host without a card prices against it too, so CPU gauges move but read
as tiny fractions.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

__all__ = [
    "MFU_GAUGE", "STEP_SECONDS_GAUGE", "TICK_EFF_GAUGE", "ChipSpec",
    "CHIP_SPECS", "DEFAULT_CHIP", "chip_spec", "train_step_flops", "mfu",
    "model_bandwidth_eff", "modeled_tick_bytes", "tree_nbytes",
    "tree_nelems",
]

MFU_GAUGE = "ptpu_train_mfu"
STEP_SECONDS_GAUGE = "ptpu_train_step_seconds"
TICK_EFF_GAUGE = "ptpu_engine_tick_model_eff"


@dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_bandwidth: float      # bytes / s
    peak_flops: float         # dense bf16 FLOP / s


DEFAULT_CHIP = "NVIDIA H100 80GB HBM3"
CHIP_SPECS = {
    DEFAULT_CHIP: ChipSpec(DEFAULT_CHIP, 3.35e12, 989e12),
}


def chip_spec(chip=None) -> ChipSpec:
    """The card for the efficiency denominator: a ChipSpec passes
    through (the engine resolves once and hands it back per tick), a
    name looks up ``CHIP_SPECS``, None reads ``PADDLE_TPU_EFF_CHIP``, else
    the name of card 0, else (no card) ``DEFAULT_CHIP``. A card missing
    from the table raises: set ``PADDLE_TPU_EFF_CHIP``."""
    if chip is not None and not isinstance(chip, str):
        return chip
    if chip is None:
        chip = os.environ.get("PADDLE_TPU_EFF_CHIP")
    if chip is None:
        import torch
        chip = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                else DEFAULT_CHIP)
    if chip not in CHIP_SPECS:
        raise KeyError(f"no efficiency entry for {chip!r} (known: "
                       f"{sorted(CHIP_SPECS)}); set PADDLE_TPU_EFF_CHIP")
    return CHIP_SPECS[chip]


def train_step_flops(param_count: int, tokens: int) -> float:
    """Nominal model FLOPs for training ``tokens`` tokens: 6 * N * T
    (forward 2NT + backward 4NT)."""
    return 6.0 * float(param_count) * float(tokens)


def mfu(model_flops: float, seconds: float, chip=None) -> float:
    """Model-FLOPs utilisation: useful FLOPs over what the card could do
    in the measured wall time."""
    if seconds <= 0:
        return 0.0
    return float(model_flops) / (float(seconds)
                                 * chip_spec(chip).peak_flops)


def model_bandwidth_eff(modeled_bytes: float, seconds: float,
                        chip=None) -> float:
    """Modeled HBM bytes per measured second, as a fraction of the card's
    bandwidth (the decode tick's efficiency)."""
    if seconds <= 0:
        return 0.0
    return float(modeled_bytes) / (float(seconds)
                                   * chip_spec(chip).hbm_bandwidth)


def _decode_bytes(g: dict) -> int:
    # hlo_cost.analytic_decode_hbm_bytes: every micro-step streams the
    # weights once and makes 7 passes over the KV cache
    return int(g["tick_tokens"] * (g["param_bytes"]
                                   + 7 * g["kv_cache_bytes"]))


def _paged_decode_bytes(g: dict) -> int:
    # hlo_cost.analytic_paged_decode_hbm_bytes: 4 passes over the pool, 3
    # over the gathered [N, pages_per_slot * page] view
    return int(g["tick_tokens"] * (g["param_bytes"]
                                   + 4 * g["kv_cache_bytes"]
                                   + 3 * g["kv_view_bytes"]))


def _verify_bytes(g: dict) -> int:
    # hlo_cost.analytic_verify_hbm_bytes: ONE forward of the k+1 block —
    # weights once, the cache's 7 passes once
    return int(g["param_bytes"] + 7 * g["kv_cache_bytes"])


def modeled_tick_bytes(kind: str, geometry: dict) -> int:
    """Analytic HBM bytes of one engine dispatch by program kind:

      "decode"        dense slot tick   (tick_tokens, param, kv bytes)
      "decode_paged"  paged tick        (+ kv_view_bytes)
      "verify"        speculative verify-k dispatch (single pass)
    """
    fn = {"decode": _decode_bytes, "decode_paged": _paged_decode_bytes,
          "verify": _verify_bytes}.get(kind)
    if fn is None:
        raise ValueError(f"unknown tick kind {kind!r} "
                         "(valid: decode, decode_paged, verify)")
    return fn(geometry)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _numel(leaf) -> int:
    n = 1
    for d in tuple(getattr(leaf, "shape", ()) or ()):
        n *= int(d)
    return n


def tree_nbytes(tree) -> int:
    """Total bytes of the tensors (or numpy arrays) in nested
    dicts / lists / tuples — the geometry input the analytic bounds
    take."""
    total = 0
    for leaf in _leaves(tree):
        size = getattr(leaf, "element_size", None)
        if callable(size):                  # torch.Tensor
            total += _numel(leaf) * size()
        else:
            total += _numel(leaf) * getattr(
                getattr(leaf, "dtype", None), "itemsize", 4)
    return total


def tree_nelems(tree) -> int:
    """Total element count of the tensors in a tree (the parameter count
    the training MFU formula takes)."""
    return sum(_numel(leaf) for leaf in _leaves(tree))
