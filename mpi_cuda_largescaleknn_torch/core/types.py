"""Core tensor types.

Points are ``f32[N, D]`` tensors (``D = 3`` for ``.float3`` input). The
per-query candidate list is SoA ``(f32[N, k] dist2, i32[N, k] idx)``, kept
ascending by dist2 — the same layout and semantics as the JAX package's
``core/types.py``. Shards are padded to a uniform size with ``PAD_SENTINEL``
coordinates: a sentinel sits ~1e30 from any real point, so its squared
distance overflows f32 to +inf and it can never displace a real candidate
(nor a cutoff-radius slot).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Far-away-but-finite coordinate for padding points. (1e30)^2 overflows f32
# to +inf, while finite-minus-finite subtraction avoids the inf-inf => nan
# trap.
PAD_SENTINEL = 1.0e30


class CandidateState(NamedTuple):
    """Persistent per-query top-k accumulator (one row per query).

    ``dist2`` ascending per row; empty slots hold ``max_radius**2`` (+inf
    when no ``-r`` given) and idx -1."""

    dist2: torch.Tensor  # f32[num_queries, k]
    idx: torch.Tensor    # i32[num_queries, k]


class Aabb(NamedTuple):
    """Axis-aligned bounding box (the reference's ``cukd::box_t<float3>``:
    six contiguous floats)."""

    lower: torch.Tensor  # f32[D]
    upper: torch.Tensor  # f32[D]


def aabb_of_points(points: torch.Tensor,
                   valid_mask: torch.Tensor | None = None) -> Aabb:
    """Bounds of the real (non-sentinel) rows of ``f32[N, D]``. An empty set
    gives lower=+inf, upper=-inf (the ``setEmpty()`` convention)."""
    if valid_mask is None:
        valid_mask = points[:, 0] < PAD_SENTINEL / 2
    lo = torch.where(valid_mask[:, None], points, torch.inf).amin(dim=0)
    hi = torch.where(valid_mask[:, None], points, -torch.inf).amax(dim=0)
    return Aabb(lo, hi)


def aabb_box_distance(a_lower, a_upper, b_lower, b_upper) -> torch.Tensor:
    """Min Euclidean distance between boxes (broadcast over leading axes):
    per component ``max(0, max(a.lo - b.hi, b.lo - a.hi))``, squares summed
    left to right in f32, then the root taken in f64 and rounded once, the
    correctly rounded f32 root (PyTorch's vectorized f32 ``sqrt`` on the CPU
    can be 1 ulp off, which would move a prune decision). An empty box
    (inverted inf bounds) is +inf away: a nan from inf - inf becomes +inf."""
    diff = torch.clamp_min(torch.maximum(a_lower - b_upper,
                                         b_lower - a_upper), 0.0)
    d2 = None
    for i in range(diff.shape[-1]):
        sq = diff[..., i] * diff[..., i]
        d2 = sq if d2 is None else d2 + sq
    d2 = torch.where(torch.isnan(d2), torch.inf, d2)
    return torch.sqrt(d2.double()).float()
