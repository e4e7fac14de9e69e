"""Binary output, byte-compatible with the reference.

- unordered pipeline: ONE ``.float`` file with every point's k-th-NN
  distance in global point order (the reference's rank-serialized append,
  done as a single write), and optionally the neighbor ids;
- pre-partitioned pipeline: one ``prefix_%06d.float`` file per shard, and
  optionally ``prefix_%06d.int32`` neighbor ids.
"""

from __future__ import annotations

import numpy as np


def write_distances(path: str, distances: np.ndarray) -> None:
    np.asarray(distances, np.float32).tofile(path)


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
