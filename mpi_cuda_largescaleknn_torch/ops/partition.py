"""Spatial bucketing: median-split partition into contiguous leaf tiles.

The port of the JAX package's ``ops/partition.py``. The point set is
recursively median-split (each segment along its widest real-point extent,
one stable sort per level) into ``B = 2^L`` equal-size contiguous buckets,
each with a tight AABB over its real points. The bucketed array plus bounds
is the tree: traversal visits buckets nearest-first and prunes on box
distance. Bucket contents, bounds and visit order are bit-identical to the
JAX package's, because the traversal's tie ids depend on them.

Sentinel padding rows (``PAD_SENTINEL`` coords) sort above every real
coordinate, so they gather in the trailing buckets; empty buckets carry
inverted (+inf/-inf) bounds that every box distance reports as +inf.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mpi_cuda_largescaleknn_torch.core.types import PAD_SENTINEL
from mpi_cuda_largescaleknn_torch.utils.math import cdiv, next_pow2, round_up


class BucketedPoints(NamedTuple):
    """A point shard in bucket-contiguous order plus per-bucket bounds.

    ``ids`` carry global point identities (-1 = padding); ``pos`` maps each
    bucketed row back to its row in the input array (-1 = padding)."""

    pts: torch.Tensor    # f32[B, S, D]
    ids: torch.Tensor    # i32[B, S]
    lower: torch.Tensor  # f32[B, D] (+inf rows for empty buckets)
    upper: torch.Tensor  # f32[B, D] (-inf rows for empty buckets)
    pos: torch.Tensor    # i32[B, S] row index into the input, -1 = pad

    @property
    def num_buckets(self) -> int:
        return self.pts.shape[0]

    @property
    def bucket_size(self) -> int:
        return self.pts.shape[1]


def choose_buckets(n: int, bucket_size_target: int) -> tuple[int, int]:
    """(B, S): B = power-of-two bucket count, S = padded bucket size
    (multiple of 8) with B*S >= n and S close to the target."""
    b = next_pow2(max(1, cdiv(n, max(bucket_size_target, 1))))
    s = round_up(max(cdiv(n, b), 1), 8)
    return b, s


def _valid_rows(coords: torch.Tensor) -> torch.Tensor:
    return coords[..., 0:1] < PAD_SENTINEL / 2


def partition_prep(points: torch.Tensor, point_ids: torch.Tensor | None, *,
                   num_buckets: int, bucket_size: int):
    """Stage 1: pad to ``B*S`` rows. Returns ``(coords f32[B*S, D],
    ids i32[B*S], pos i32[B*S])``."""
    n, d = points.shape
    dev = points.device
    if point_ids is None:
        point_ids = torch.arange(n, dtype=torch.int32, device=dev)
    pad = num_buckets * bucket_size - n
    coords = torch.cat([points.to(torch.float32),
                        torch.full((pad, d), PAD_SENTINEL,
                                   dtype=torch.float32, device=dev)])
    ids = torch.cat([point_ids.to(torch.int32),
                     torch.full((pad,), -1, dtype=torch.int32, device=dev)])
    pos = torch.cat([torch.arange(n, dtype=torch.int32, device=dev),
                     torch.full((pad,), -1, dtype=torch.int32, device=dev)])
    return coords, ids, pos


def partition_level(coords: torch.Tensor, ids: torch.Tensor,
                    pos: torch.Tensor, num_seg: int, *, num_buckets: int,
                    bucket_size: int):
    """One median-split level: within each of ``num_seg`` equal contiguous
    segments, a stable sort by the coordinate along the segment's widest
    real-point extent (the first widest, as ``argmax`` picks). Segments are
    contiguous row ranges, so the JAX package's stable 2-key sort by
    (segment, key) is a stable sort of each segment's row."""
    n_tot, d = coords.shape
    seg = n_tot // num_seg
    fine = coords.view(num_buckets, bucket_size, d)
    valid = _valid_rows(fine)
    lo = torch.where(valid, fine, torch.inf).amin(dim=1)          # [B, D]
    hi = torch.where(valid, fine, -torch.inf).amax(dim=1)
    lo = lo.view(num_seg, num_buckets // num_seg, d).amin(dim=1)  # [seg, D]
    hi = hi.view(num_seg, num_buckets // num_seg, d).amax(dim=1)
    ext = hi - lo
    dim = torch.argmax(torch.where(torch.isfinite(ext), ext, -torch.inf),
                       dim=1)                                     # [seg]
    key = torch.gather(coords.view(num_seg, seg, d), 2,
                       dim.view(num_seg, 1, 1).expand(num_seg, seg, 1))
    _, perm = torch.sort(key.view(num_seg, seg), dim=1, stable=True)
    perm = (perm + torch.arange(num_seg, device=coords.device).view(-1, 1)
            * seg).view(-1)
    return coords[perm], ids[perm], pos[perm]


def partition_finalize(coords: torch.Tensor, ids: torch.Tensor,
                       pos: torch.Tensor, *, num_buckets: int,
                       bucket_size: int) -> BucketedPoints:
    """Stage 3: reshape the sorted rows into buckets + AABBs."""
    pts = coords.view(num_buckets, bucket_size, coords.shape[1])
    valid = _valid_rows(pts)
    lower = torch.where(valid, pts, torch.inf).amin(dim=1)
    upper = torch.where(valid, pts, -torch.inf).amax(dim=1)
    return BucketedPoints(pts, ids.view(num_buckets, bucket_size), lower,
                          upper, pos.view(num_buckets, bucket_size))


def partition_points(points: torch.Tensor,
                     point_ids: torch.Tensor | None = None, *,
                     bucket_size: int = 512) -> BucketedPoints:
    """Partition ``f32[N, D]`` into ``B`` contiguous median-split buckets
    on the device ``points`` lies on."""
    num_buckets, bucket_size = choose_buckets(points.shape[0], bucket_size)
    cols = partition_prep(points, point_ids, num_buckets=num_buckets,
                          bucket_size=bucket_size)
    for level in range(int(math.log2(num_buckets))):
        cols = partition_level(*cols, 1 << level, num_buckets=num_buckets,
                               bucket_size=bucket_size)
    return partition_finalize(*cols, num_buckets=num_buckets,
                              bucket_size=bucket_size)


def bucket_box_dist2(q_lower, q_upper, p_lower, p_upper) -> torch.Tensor:
    """Squared min box-to-box distance matrix f32[Bq, Bp]: per-component
    ``max(0, max(q.lo - p.hi, p.lo - q.hi))``, squares summed left to
    right. Empty buckets (inverted inf bounds) give +inf.

    One component at a time on [Bq, Bp] tensors: the broadcast [Bq, Bp, D]
    form would hold 4.3 GB per temporary at 1M points and D=128. Each
    element sees the same operations, so the bits are the broadcast form's.
    (The JAX package sums the D axis with ``jnp.sum``, whose order XLA may
    change at large D: there the box d2, and with it the visit order, can
    differ by an ulp; distances and ids on tie-free data do not.)"""
    d2 = None
    for i in range(q_lower.shape[-1]):
        diff = torch.clamp_min(
            torch.maximum(q_lower[:, None, i] - p_upper[None, :, i],
                          p_lower[None, :, i] - q_upper[:, None, i]), 0.0)
        sq = diff * diff
        d2 = sq if d2 is None else d2 + sq
    return torch.where(torch.isnan(d2), torch.inf, d2)


def nearest_first_order(q_lower, q_upper, p_lower, p_upper):
    """Per query bucket, point buckets in ascending box-distance order:
    ``(sorted_d2 f32[Bq, Bp], order i32[Bq, Bp])``. The sort is stable —
    many box distances are exactly 0, so stability fixes the visit order
    and with it the traversal's tie ids."""
    box_d2 = bucket_box_dist2(q_lower, q_upper, p_lower, p_upper)
    sorted_d2, order = torch.sort(box_d2, dim=1, stable=True)
    return sorted_d2, order.to(torch.int32)


def coarsen_buckets(q: BucketedPoints, group: int) -> BucketedPoints:
    """Merge ``group`` adjacent buckets into one — the same tensors viewed
    with ``group``x wider buckets. The median-split hierarchy is nested, so
    the merged bucket is spatially contiguous and the union of the AABBs is
    tight."""
    if group == 1:
        return q
    b, s = q.ids.shape
    d = q.pts.shape[-1]
    if b % group:
        raise ValueError(f"{b} buckets do not coarsen by {group}")
    bc = b // group
    return BucketedPoints(
        q.pts.view(bc, group * s, d),
        q.ids.view(bc, group * s),
        q.lower.view(bc, group, d).amin(dim=1),
        q.upper.view(bc, group, d).amax(dim=1),
        q.pos.view(bc, group * s))


def scatter_back(values: torch.Tensor, pos: torch.Tensor, n_out: int,
                 fill=0) -> torch.Tensor:
    """Scatter bucket-order ``values`` (any [B, S, ...]) back to input-row
    order; padding rows (pos == -1) are dropped, and input rows not covered
    by ``pos`` hold ``fill``."""
    flat_pos = pos.reshape(-1).long()
    flat_val = values.reshape((flat_pos.shape[0],) + values.shape[2:])
    # padding rows land on one extra row that is cut off: a boolean mask
    # would make the host wait for the card to count its rows
    flat_pos = torch.where(flat_pos >= 0, flat_pos, n_out)
    out = torch.full((n_out + 1,) + flat_val.shape[1:], fill,
                     dtype=flat_val.dtype, device=flat_val.device)
    out[flat_pos] = flat_val
    return out[:n_out]
