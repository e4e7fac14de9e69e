"""Small integer helpers (host-side, static-shape arithmetic) and the
Morton bit dilation of the file partitioner."""

import numpy as np


def cdiv(a: int, b: int) -> int:
    """Ceiling division (the reference's ``cukd::divRoundUp``)."""
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    """Round ``a`` up to the next multiple of ``b``."""
    return cdiv(a, b) * b


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    p = 1
    while p < n:
        p <<= 1
    return p


def _part1by2(v: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of each uint64 so bit i lands at bit 3*i
    (the classic 64-bit magic-mask dilation)."""
    v = v.astype(np.uint64)
    v &= np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0xF00F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x30C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x9249249249249249)
    return v
