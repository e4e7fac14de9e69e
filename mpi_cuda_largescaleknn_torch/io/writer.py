"""Binary output, byte-compatible with the reference.

- unordered pipeline: ONE ``.float`` file with every point's k-th-NN
  distance in global point order (the reference's rank-serialized append,
  done as a single write), and optionally the neighbor ids;
- pre-partitioned pipeline: one ``prefix_%06d.float`` file per shard, and
  optionally ``prefix_%06d.int32`` neighbor ids;
- ``write_distances_slab``: one host's slab of the unordered pipeline's
  file, written at its offset, so that hosts need not take turns.
"""

from __future__ import annotations

import os

import numpy as np

from mpi_cuda_largescaleknn_torch.io import native


def write_distances(path: str, distances: np.ndarray) -> None:
    np.asarray(distances, np.float32).tofile(path)


def write_distances_slab(path: str, begin_record: int,
                         distances: np.ndarray, total_records: int,
                         presize: bool = False) -> None:
    """Write one slab of the ONE global ``.float`` file at its record
    offset: the reference's rank-by-rank append without the turns. One
    writer (host 0 by convention) runs with ``presize`` before the others
    write, which sizes the file at ``total_records`` records, so that a
    longer file from an earlier run keeps no stale trailing bytes. Native
    positioned writes where ``g++`` exists, else numpy."""
    data = np.ascontiguousarray(np.asarray(distances, np.float32))
    if native.available():
        if presize:
            native.native_create_sized(path, total_records * 4)
        native.native_write_at(path, begin_record * 4, data)
        return
    if presize or not os.path.exists(path):
        with open(path, "wb") as f:
            f.truncate(total_records * 4)
    with open(path, "r+b") as f:
        f.seek(begin_record * 4)
        f.write(data.tobytes())


def write_indices(path: str, idx: np.ndarray) -> None:
    """Row-major i32[N, k] neighbor ids (-1 = fewer than k found)."""
    np.asarray(idx, np.int32).tofile(path)


def write_rank_file(prefix: str, rank: int, distances: np.ndarray) -> str:
    """Write one shard's results as ``<prefix>_%06d.float``."""
    path = f"{prefix}_{rank:06d}.float"
    write_distances(path, distances)
    return path


def write_rank_indices(prefix: str, rank: int, idx: np.ndarray) -> str:
    """Write one shard's neighbor ids as ``<prefix>_%06d.int32``."""
    path = f"{prefix}_{rank:06d}.int32"
    write_indices(path, idx)
    return path
