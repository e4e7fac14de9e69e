"""Host-side shard layout helpers.

Slab semantics follow the reference's ``readFilePortion``: shard r of R
owns rows ``[N*r/R, N*(r+1)/R)`` of the global array (sizes differ by at
most one), so concatenating per-shard results in rank order reproduces the
reference's single-output-file byte layout.
"""

from __future__ import annotations

import numpy as np

from mpi_cuda_largescaleknn_torch.core.types import PAD_SENTINEL


def check_neighbor_id_capacity(n_total: int) -> None:
    """Neighbor ids are int32: ids 0..n-1 fit while n <= 2^31. Beyond that
    the wrap in ``pad_and_flatten`` keeps distances right but makes ids
    ambiguous — refuse rather than emit wrong identities."""
    if n_total > 2**31:
        raise ValueError("neighbor ids are int32: datasets beyond 2^31 "
                         "points must use the distance-only path")


def slab_bounds(num_total: int, num_shards: int) -> list[tuple[int, int]]:
    return [(num_total * r // num_shards, num_total * (r + 1) // num_shards)
            for r in range(num_shards)]


def pad_and_flatten(shards: list[np.ndarray], id_bases: list[int],
                    dim: int, pad_to: int | None = None):
    """Pack per-shard point arrays into the shard-major layout.

    Returns (points f32[R*Npad, D], ids i32[R*Npad], counts [R], Npad) with
    Npad = the largest shard (or ``pad_to``, which must cover it: the slab
    pool's common shape class) and padding rows = PAD_SENTINEL / id -1.
    ``id_bases[r]`` is shard r's global index offset. Beyond 2^31 points
    ids wrap modulo 2^31 and stay non-negative (the distance path only
    reads an id's sign)."""
    num_shards = len(shards)
    counts = [len(s) for s in shards]
    npad = max(max(counts), 1)
    if pad_to is not None:
        if pad_to < npad:
            raise ValueError(f"pad_to={pad_to} < largest shard {npad}")
        npad = pad_to
    points = np.full((num_shards * npad, dim), PAD_SENTINEL, np.float32)
    ids = np.full(num_shards * npad, -1, np.int32)
    for r, s in enumerate(shards):
        points[r * npad:r * npad + counts[r]] = np.asarray(s, np.float32)
        gids = (id_bases[r] + np.arange(counts[r], dtype=np.int64)) % (2**31)
        ids[r * npad:r * npad + counts[r]] = gids.astype(np.int32)
    return points, ids, counts, npad


def slab_aabbs(points: np.ndarray, bounds: list[tuple[int, int]]) -> list[dict]:
    """Per-slab bounding boxes and point counts, JSON-ready (the serving
    engine's ``shard_bounds`` on /stats). An empty slab carries ``lo/hi =
    None`` and count 0."""
    out = []
    for b, e in bounds:
        s = np.asarray(points[b:e], np.float32)
        if len(s) == 0:
            out.append({"lo": None, "hi": None, "count": 0})
        else:
            out.append({"lo": [float(x) for x in s.min(axis=0)],
                        "hi": [float(x) for x in s.max(axis=0)],
                        "count": int(len(s))})
    return out


def trim_per_shard(flat: np.ndarray, counts: list[int], npad: int) -> list[np.ndarray]:
    """Undo the padding: per-shard arrays of true length."""
    return [np.asarray(flat[r * npad:r * npad + c]) for r, c in enumerate(counts)]
