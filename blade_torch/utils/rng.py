"""Deterministic generator folding: the port's stand-in for ``jax.random.fold_in``.

A ``torch.Generator`` is stateful, so handing one generator to every step and
layer would make the draws depend on call order.  ``fold_generator(g, i)``
instead derives a fresh generator from ``g``'s seed and ``i`` alone, on
``g``'s device, which keeps each step's and each layer's draws independent
of what ran before.  The bits differ from JAX's: tests that compare the two
packages inject the random values instead.
"""

from __future__ import annotations

import torch

__all__ = ["fold_seed", "fold_generator", "make_generator"]

_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, data: int) -> int:
    """Mix ``data`` into ``seed`` (splitmix64 finalizer); a 63-bit result."""
    x = (seed ^ ((data + 1) * 0x9E3779B97F4A7C15)) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def make_generator(seed: int, device="cpu") -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def fold_generator(gen: torch.Generator, data: int) -> torch.Generator:
    """A new generator on ``gen``'s device seeded by ``fold_seed(seed, data)``."""
    return make_generator(fold_seed(gen.initial_seed(), int(data)), gen.device)
