"""Math utilities (the JAX package's ``util/math_utils.py``): so far only
``next_pow_of_2``, which the serving engine's buckets and the singleton
decodes share. The statistics helpers are not ported yet."""

from __future__ import annotations


def next_pow_of_2(v: int) -> int:
    """Smallest power of two >= v (MathUtils.java:95)."""
    if v <= 0:
        return 1
    return 1 << (int(v - 1).bit_length())
