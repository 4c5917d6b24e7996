"""Small helpers; the port's own copy of tfimm_tpu/utils/etc.py."""

from __future__ import annotations

import collections.abc
from itertools import repeat

__all__ = ["to_2tuple", "make_divisible"]


def to_2tuple(x):
    if isinstance(x, collections.abc.Iterable) and not isinstance(x, str):
        return tuple(x)
    return tuple(repeat(x, 2))


def make_divisible(value, divisor=8, min_value=None, round_limit=0.9):
    """Round channel counts to a multiple of ``divisor`` without dropping >10%."""
    min_value = min_value or divisor
    new_value = max(min_value, int(value + divisor / 2) // divisor * divisor)
    if new_value < round_limit * value:
        new_value += divisor
    return new_value
