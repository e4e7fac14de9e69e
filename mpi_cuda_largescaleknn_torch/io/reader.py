"""Binary point-file input, byte-compatible with the reference.

``.float3`` input is raw little-endian f32 triples with no header
(``readFilePortion<float3>``). A file-of-filenames (the pre-partitioned
pipeline's input) holds one path per line; every non-empty line counts
(the reference drops a last line without a trailing newline, a latent bug
rather than a contract). Slabs are read by the native library's threaded
positioned reads (``io/native.py``) where ``g++`` exists, else by numpy.
"""

from __future__ import annotations

import os

import numpy as np

from mpi_cuda_largescaleknn_torch.io import native

_RECORD_BYTES = 12  # one float3


def read_file_portion(path: str, rank: int, size: int):
    """Read shard ``rank`` of ``size``'s contiguous slab of a ``.float3``
    file; slab bounds are ``numData*rank/size .. numData*(rank+1)/size``,
    the reference's integer arithmetic. Returns (points f32[n,3], begin,
    num_total)."""
    num_data = os.path.getsize(path) // _RECORD_BYTES
    begin = num_data * rank // size
    end = num_data * (rank + 1) // size
    if native.available():
        # a native read that runs and fails raises: re-reading with numpy
        # would hide a short read
        return native.native_read_slab(path, begin, end - begin), begin, \
            num_data
    with open(path, "rb") as f:
        f.seek(begin * _RECORD_BYTES)
        pts = np.fromfile(f, dtype=np.float32, count=(end - begin) * 3)
    return pts.reshape(-1, 3), begin, num_data


def read_points(path: str) -> np.ndarray:
    """Whole-file read (the pre-partitioned pipeline's per-rank
    ``readFilePortion(..., 0, 1)``). ``.npy`` inputs hold any
    f32-coercible [N, D] array."""
    if path.endswith(".npy"):
        pts = np.asarray(np.load(path), np.float32)
        if pts.ndim != 2 or pts.shape[1] < 1:
            raise ValueError(f"{path}: expected an [N, D] array, got "
                             f"shape {list(pts.shape)}")
        return pts
    pts, _, _ = read_file_portion(path, 0, 1)
    return pts


def read_list_of_file_names(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]
