"""Post-run sampled verification (``--selfcheck N``).

Recomputes N sampled points' k-th-NN distances exactly (streamed numpy
brute force, bounded memory) and fails loudly on a mismatch.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def kth_distance_exact(points: np.ndarray, query_idx: np.ndarray, k: int,
                       max_radius: float = np.inf,
                       budget_elems: int = 16_000_000) -> np.ndarray:
    """Exact k-th-NN distance for ``points[query_idx]`` against ALL points.
    The query rows are split over up to 8 threads (numpy's loops release
    the GIL), each streaming the points in blocks that keep its distance
    slab within ``budget_elems / threads`` elements."""
    q = points[query_idx].astype(np.float32)
    workers = max(1, min(os.cpu_count() or 1, 8, len(q)))
    chunks = np.array_split(q, workers)
    block = max(1024, budget_elems // workers // max(1, len(chunks[0])))
    with ThreadPoolExecutor(workers) as pool:
        parts = list(pool.map(
            lambda c: _kth_rows(points, c, k, max_radius, block), chunks))
    return np.concatenate(parts)


def _kth_rows(points: np.ndarray, q: np.ndarray, k: int, max_radius: float,
              block: int) -> np.ndarray:
    nq = len(q)
    # running k-smallest per query (unsorted; only the max matters)
    best = np.full((nq, k), np.float32(max_radius) ** 2, np.float32)
    acc = np.empty((nq, block), np.float32)
    tmp = np.empty_like(acc)
    for lo in range(0, len(points), block):
        p = points[lo:lo + block].astype(np.float32)
        d2, t = acc[:, :len(p)], tmp[:, :len(p)]
        # ((d0*d0 + d1*d1) + d2*d2), in place
        np.subtract(q[:, None, 0], p[None, :, 0], out=d2)
        np.multiply(d2, d2, out=d2)
        for i in range(1, q.shape[1]):
            np.subtract(q[:, None, i], p[None, :, i], out=t)
            np.multiply(t, t, out=t)
            np.add(d2, t, out=d2)
        # only entries below a row's current k-th can change it: gather
        # them into a narrow padded slab before the partition
        rows, cols = np.nonzero(d2 < best.max(axis=1)[:, None])
        if len(rows):
            counts = np.bincount(rows, minlength=nq)
            slot = np.arange(len(rows)) - (np.cumsum(counts) - counts)[rows]
            cand = np.full((nq, counts.max()), np.inf, np.float32)
            cand[rows, slot] = d2[rows, cols]
            best = np.partition(np.concatenate([best, cand], axis=1), k - 1,
                                axis=1)[:, :k]
    return np.sqrt(best.max(axis=1))


def verify_sample(points: np.ndarray, dists: np.ndarray, k: int,
                  num_samples: int, max_radius: float = np.inf,
                  seed: int = 0, rtol: float = 1e-5,
                  atol: float = 1e-6) -> int:
    """Check ``num_samples`` random outputs against the exact answer.

    Returns the number checked; raises AssertionError with the worst
    offender on mismatch. The tolerance is a safety margin over the
    bitwise-equal f32 recipe both sides use; inf patterns (under-full
    rows) must match exactly."""
    n = len(points)
    num_samples = min(num_samples, n)
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=num_samples, replace=False)
    want = kth_distance_exact(points, idx, k, max_radius)
    got = np.asarray(dists)[idx]
    inf_mismatch = np.isinf(got) != np.isinf(want)
    if inf_mismatch.any():
        i = int(np.argmax(inf_mismatch))
        raise AssertionError(
            f"selfcheck FAILED: point {idx[i]} got {got[i]}, exact {want[i]}")
    finite = ~np.isinf(want)
    if not np.allclose(got[finite], want[finite], rtol=rtol, atol=atol):
        err = np.abs(got[finite] - want[finite])
        i = int(np.argmax(err))
        gi = idx[finite][i]
        raise AssertionError(
            f"selfcheck FAILED: point {gi} got {got[finite][i]}, "
            f"exact {want[finite][i]} (|err| {err[i]:.3g})")
    return num_samples
