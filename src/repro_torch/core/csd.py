"""Canonical signed digit (CSD) arithmetic: a numpy copy of what the port
uses of ``repro/core/csd.py``.

CSD writes an integer as sum_i d_i 2^i with d_i in {-1, 0, +1}, no two
adjacent nonzero digits, and the minimum possible number of nonzero digits.
The paper's hardware-cost proxy ``tnzd`` is the total nonzero-digit count of
all weights/biases under CSD (Section II-B, footnote 1).

Two engines, bit-identical on ``|v| < 2**61`` (DESIGN.md 11.1):

* the scalar digit-at-a-time recoding (``to_csd`` / ``from_csd`` and
  ``drop_least_significant_digit``), which the serial tuner uses;
* the array engine: the nonzero-digit positions of ``v`` are the set bits
  of ``(3v XOR v) >> 1`` and the digit at position ``i`` is ``+1`` iff bit
  ``i`` of ``(3v) >> 1`` is set, so three vector ops recode a whole array
  into ``(D, ...)`` digit planes, the layout the digit-plane kernels take.
"""
from __future__ import annotations

import numpy as np

__all__ = ["to_csd", "from_csd", "tnzd",
           "drop_least_significant_digit", "to_csd_array", "from_csd_array",
           "nnz_array", "drop_least_significant_digit_array",
           "largest_left_shift_array"]

# Valid domain of the array engine: |v| < 2^61 keeps 3*v inside int64.
_MAX_ABS = 1 << 61


def to_csd(value: int) -> list[int]:
    """CSD digits of ``value``, least-significant first; ``[]`` for 0.

    Scan LSB->MSB; at an odd remainder take the digit ``d = 2 - (v mod 4)``
    (a run of ones ``0111..1`` becomes ``100..0(-1)``)."""
    value = int(value)
    digits: list[int] = []
    while value != 0:
        if value & 1:
            d = 2 - (value & 3)
            digits.append(d)
            value -= d
        else:
            digits.append(0)
        value >>= 1
    return digits


def from_csd(digits: list[int]) -> int:
    return sum(d << i for i, d in enumerate(digits))


def drop_least_significant_digit(value: int) -> int:
    """Remove the least-significant nonzero CSD digit (paper IV-B 2a);
    0 when ``value`` has a single nonzero digit."""
    digits = to_csd(value)
    for i, d in enumerate(digits):
        if d != 0:
            digits[i] = 0
            return from_csd(digits)
    return 0


def _csd_masks(values) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(v, nz, plus): ``nz`` bit i set iff CSD digit i of v is nonzero;
    ``plus`` bit i set iff that digit is +1.  Exact for ``|v| < 2**61``."""
    v = np.asarray(values, dtype=np.int64)
    # min/max, not abs: np.abs(int64 min) wraps back to int64 min
    if v.size and (int(v.min()) <= -_MAX_ABS or int(v.max()) >= _MAX_ABS):
        raise OverflowError("array CSD engine requires |v| < 2**61")
    v3 = 3 * v
    nz = (v3 ^ v) >> 1          # nonnegative: sign bits of v3 and v agree
    plus = v3 >> 1
    return v, nz, plus


def _popcount(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    if hasattr(np, "bitwise_count"):                  # numpy >= 2.0
        return np.bitwise_count(x).astype(np.int64)
    x = x - ((x >> np.uint64(1)) & np.uint64(0x5555555555555555))
    x = ((x >> np.uint64(2)) & np.uint64(0x3333333333333333)) \
        + (x & np.uint64(0x3333333333333333))
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    return ((x * np.uint64(0x0101010101010101)) >> np.uint64(56)) \
        .astype(np.int64)


def to_csd_array(values, depth: int | None = None) -> np.ndarray:
    """``(D, *values.shape)`` int8 CSD digit planes, least-significant
    first.  ``D`` is the smallest depth covering every element (>= 1), or
    ``depth`` when given (which must cover; planes past the last nonzero
    digit are 0).  Bit-identical to stacking the scalar ``to_csd`` lists."""
    v, nz, plus = _csd_masks(values)
    need = int(nz.max()).bit_length() if v.size else 0
    if depth is None:
        depth = max(1, need)
    elif need > depth:
        raise ValueError(f"depth {depth} < required digit depth {need}")
    shifts = np.arange(depth, dtype=np.int64).reshape((depth,) + (1,) * v.ndim)
    bits = (nz[None] >> shifts) & 1
    sign = (((plus[None] >> shifts) & 1) << 1) - 1
    return (bits * sign).astype(np.int8)


def from_csd_array(planes: np.ndarray) -> np.ndarray:
    """Inverse of :func:`to_csd_array`: ``(D, ...)`` digit planes -> values."""
    planes = np.asarray(planes, dtype=np.int64)
    weights = (np.int64(1) << np.arange(planes.shape[0], dtype=np.int64)) \
        .reshape((planes.shape[0],) + (1,) * (planes.ndim - 1))
    return (planes * weights).sum(axis=0)


def nnz_array(values) -> np.ndarray:
    """Per-element nonzero CSD digit counts (``nnz`` over a whole array)."""
    _, nz, _ = _csd_masks(values)
    return _popcount(nz)


def tnzd(int_arrays) -> int:
    """Total nonzero CSD digits over a collection of integer arrays: the
    paper's high-level hardware cost (Tables I-IV column tnzd)."""
    return int(sum(int(nnz_array(arr).sum()) for arr in int_arrays))


def drop_least_significant_digit_array(values) -> np.ndarray:
    """Whole-array :func:`drop_least_significant_digit`: subtract each
    element's least-significant nonzero CSD digit (zeros stay zero)."""
    v, nz, plus = _csd_masks(values)
    low = nz & -nz                       # lowest nonzero-digit position bit
    sign = np.where(plus & low, np.int64(1), np.int64(-1))
    return v - sign * low


def largest_left_shift_array(values) -> np.ndarray:
    """Trailing zero bits of each element (value = odd << lls), with the
    sentinel 63 for zeros so they never constrain a smallest left shift."""
    v = np.asarray(values, dtype=np.int64)
    low = v & -v
    return np.where(v == 0, np.int64(63), _popcount(low - 1))
