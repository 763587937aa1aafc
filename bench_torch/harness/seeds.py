"""Seeds of a run's inputs, derived from ``--seed`` alone.

Every input of a run (weights, text embeddings, a request's or a step's
generator) comes from ``derive(seed, stream, index)``, so the same seed
gives the same inputs in every run and the reference can draw them again
without taking anything from the program.  The mixing is splitmix64's
finaliser; any seed up to 2**64 is taken.
"""

from __future__ import annotations

_MASK64 = (1 << 64) - 1

# Streams of derived seeds.
TEXT, REQUEST, WARM, CHECK = 11, 12, 13, 14


def mix(seed: int, data: int) -> int:
    """A 63-bit seed from ``seed`` and ``data`` (splitmix64 finaliser)."""
    x = (int(seed) ^ ((int(data) + 1) * 0x9E3779B97F4A7C15)) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def derive(seed: int, stream: int, index: int = 0) -> int:
    """The seed of item ``index`` of ``stream`` in a run seeded ``seed``."""
    return mix(mix(seed, stream), index)
