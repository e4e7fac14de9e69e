"""Small integer helpers (host-side, static-shape arithmetic), the Morton
bit dilation of the file partitioner, and the Morton codes of the serving
engine's admission sort (the JAX package's ``utils/math.py``, the same
bits)."""

import numpy as np

from mpi_cuda_largescaleknn_torch.core.types import PAD_SENTINEL


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


#: grid resolution per axis: 21 bits x 3 axes = 63 bits — one uint64 code
MORTON_BITS = 21

#: code every padding/sentinel row maps to: ABOVE any real interleaved code
#: (real codes use at most 63 bits), so a stable sort puts pads last
MORTON_PAD_CODE = np.uint64(0xFFFFFFFFFFFFFFFF)


def _compact1by2(v: np.ndarray) -> np.ndarray:
    """Inverse of ``_part1by2``: gather every third bit back together."""
    v = v.astype(np.uint64)
    v &= np.uint64(0x9249249249249249)
    v = (v | (v >> np.uint64(2))) & np.uint64(0x30C30C30C30C30C3)
    v = (v | (v >> np.uint64(4))) & np.uint64(0xF00F00F00F00F00F)
    v = (v | (v >> np.uint64(8))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v >> np.uint64(16))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v >> np.uint64(32))) & np.uint64(0x1FFFFF)
    return v


def morton_interleave(grid: np.ndarray) -> np.ndarray:
    """u64[n] Morton codes from integer grid coords ``[n, 3]`` in
    [0, 2**MORTON_BITS). Bit-exact round trip with ``morton_deinterleave``."""
    g = np.asarray(grid, np.uint64)
    return (_part1by2(g[:, 0])
            | (_part1by2(g[:, 1]) << np.uint64(1))
            | (_part1by2(g[:, 2]) << np.uint64(2)))


def morton_deinterleave(codes: np.ndarray) -> np.ndarray:
    """Integer grid coords ``[n, 3]`` back out of u64 Morton codes."""
    c = np.asarray(codes, np.uint64)
    return np.stack([_compact1by2(c),
                     _compact1by2(c >> np.uint64(1)),
                     _compact1by2(c >> np.uint64(2))], axis=1)


def morton_codes(points: np.ndarray, lo, hi,
                 bits: int = MORTON_BITS) -> np.ndarray:
    """u64[n] Morton codes of f32 points quantized to a ``2**bits`` grid
    over the [lo, hi] box (out-of-box coordinates clamp to the faces).
    Sentinel rows (``PAD_SENTINEL`` coords) map to ``MORTON_PAD_CODE``,
    strictly above every real code, so a stable sort leaves them last."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    lo = np.asarray(lo, np.float32).reshape(3)
    hi = np.asarray(hi, np.float32).reshape(3)
    top = np.float64((1 << bits) - 1)
    ext = (hi - lo).astype(np.float64)
    scale = np.where(ext > 0, top / np.where(ext > 0, ext, 1.0), 0.0)
    grid = np.clip((pts.astype(np.float64) - lo) * scale, 0.0, top)
    codes = morton_interleave(grid.astype(np.uint64))
    valid = pts[:, 0] < PAD_SENTINEL / 2
    return np.where(valid, codes, MORTON_PAD_CODE)


def morton_argsort(points: np.ndarray, lo, hi) -> np.ndarray:
    """Stable permutation sorting ``points`` by Morton code (pads last,
    equal codes keep input order): the serving admission sort."""
    return np.argsort(morton_codes(points, lo, hi), kind="stable")


def aabb_lower_bound_dist2(queries: np.ndarray, lo: np.ndarray,
                           hi: np.ndarray) -> np.ndarray:
    """f64[n, S] squared lower-bound distance from each query to each
    axis-aligned box: per axis the distance to the nearest face (0 inside
    the box), summed over axes. A point inside box s can never be closer
    to q than ``sqrt(out[q, s])``, so a box whose bound exceeds a query's
    current k-th distance cannot improve its answer (the slab pool's
    routing and certification, serve/slabpool.py). Computed in float64 so
    the bound itself adds no rounding slack (the engines' f32 rounding is
    covered by the caller's certification slack, not here)."""
    q = np.asarray(queries, np.float64)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    d = np.maximum(np.maximum(lo[None] - q[:, None], q[:, None] - hi[None]),
                   0.0)
    return np.einsum("nsd,nsd->ns", d, d)
