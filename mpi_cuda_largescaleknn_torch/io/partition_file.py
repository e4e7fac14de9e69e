"""Spatial pre-partitioning of a raw ``.float3`` file.

The reference's pre-partitioned pipeline needs one spatially coherent file
per rank but ships no tool to make them. ``partition_float3_file`` is that
tool: Morton (Z-order) binning with equal-count cuts. It streams the file
through the native library (``io/native.py`` ``native_partition``: three
passes, O(8^bits) memory, any input size) where ``g++`` exists;
``partition_float3_file_np`` is its in-memory numpy twin (about 10x the
file in memory), taken only where there is no ``g++``. Both give the same
part files, byte for byte, as the JAX package's two paths (the same
float32 quantization, the same cut positions).
"""

from __future__ import annotations

import os

import numpy as np

from mpi_cuda_largescaleknn_torch.io import native
from mpi_cuda_largescaleknn_torch.utils.math import _part1by2


def morton_codes(pts: np.ndarray, lo: np.ndarray, inv_ext: np.ndarray,
                 bits: int) -> np.ndarray:
    """Quantized 3-D Morton codes, x in the HIGH interleave position:
    float32 ``(p - lo) * inv_ext``, float64 scaling by ``2^bits - 1``,
    truncation, clamp."""
    max_q = np.uint64((1 << bits) - 1)
    t = (pts.astype(np.float32) - lo.astype(np.float32)) \
        * inv_ext.astype(np.float32)
    q = (t.astype(np.float64) * np.float64(max_q)).astype(np.uint64)
    q = np.minimum(q, max_q)
    return (_part1by2(q[:, 0]) << np.uint64(2)) \
        | (_part1by2(q[:, 1]) << np.uint64(1)) | _part1by2(q[:, 2])


def partition_float3_file_np(in_path: str, num_parts: int, out_prefix: str,
                             bits_per_dim: int = 7) -> np.ndarray:
    """Split ``in_path`` into ``<out_prefix>_%06d.float3`` parts of
    near-equal size along the Morton curve. A file that is not a whole
    number of float3 records is refused; an empty one gives empty parts.
    Returns the per-part counts."""
    if os.path.getsize(in_path) % 12 != 0:
        raise IOError(f"{in_path} is not a whole number of float3 records")
    pts = np.fromfile(in_path, np.float32).reshape(-1, 3)
    n = len(pts)
    if n == 0:
        for pr in range(num_parts):
            pts.tofile(f"{out_prefix}_{pr:06d}.float3")
        return np.zeros(num_parts, np.int64)
    lo = pts.min(axis=0)
    ext = pts.max(axis=0) - lo
    inv_ext = np.where(ext > 0, np.float32(1.0) / np.where(ext > 0, ext, 1),
                       np.float32(0.0)).astype(np.float32)
    codes = morton_codes(pts, lo, inv_ext, bits_per_dim)

    bins = 1 << (3 * bits_per_dim)
    prefix = np.cumsum(np.bincount(codes.astype(np.int64), minlength=bins))
    # cut[r] = (first bin whose inclusive prefix >= floor(n*r/parts)) + 1
    cut = np.full(num_parts + 1, bins, np.int64)
    cut[0] = 0
    for r in range(1, num_parts):
        cut[r] = np.searchsorted(prefix, n * r // num_parts, side="left") + 1
    cut = np.maximum.accumulate(cut)
    part_of = np.searchsorted(cut[1:], codes, side="right")

    counts = np.zeros(num_parts, np.int64)
    for pr in range(num_parts):
        sel = pts[part_of == pr]
        sel.tofile(f"{out_prefix}_{pr:06d}.float3")
        counts[pr] = len(sel)
    return counts


def partition_float3_file(in_path: str, num_parts: int, out_prefix: str,
                          bits_per_dim: int = 7,
                          write_file_list: bool = True) -> np.ndarray:
    """Split ``in_path`` into ``num_parts`` spatially coherent
    ``<out_prefix>_%06d.float3`` files, out of core where ``g++`` exists
    (a native run that fails raises: the in-memory twin would need ~10x
    the file at exactly the scale the native path exists for). With
    ``write_file_list``, also ``<out_prefix>.txt`` listing the parts (the
    pre-partitioned CLI's input). Returns the per-part counts."""
    if not 1 <= bits_per_dim <= 10:
        raise ValueError(f"bits_per_dim must be in [1, 10], got {bits_per_dim}")
    if num_parts < 1:
        raise ValueError(f"num_parts must be >= 1, got {num_parts}")
    if native.available():
        counts = native.native_partition(in_path, num_parts, out_prefix,
                                         bits_per_dim)
    else:
        counts = partition_float3_file_np(in_path, num_parts, out_prefix,
                                          bits_per_dim)
    if write_file_list:
        with open(f"{out_prefix}.txt", "w") as f:
            for r in range(num_parts):
                f.write(f"{out_prefix}_{r:06d}.float3\n")
    return counts
