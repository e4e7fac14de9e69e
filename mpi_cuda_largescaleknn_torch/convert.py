"""State carried across from the JAX package.

This system has no weights: its state is the partitioned point shards and
the candidate rows. These helpers take the JAX package's
``BucketedPoints`` / ``CandidateState`` — as any objects with the same
fields holding numpy-convertible arrays, so this module imports neither
JAX nor the JAX package — and build the port's on a chosen device.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_cuda_largescaleknn_torch.core.types import CandidateState
from mpi_cuda_largescaleknn_torch.ops.partition import BucketedPoints


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def bucketed_points(bp, device="cpu") -> BucketedPoints:
    """The port's ``BucketedPoints`` from one with the JAX layout
    (pts f32[B,S,D], ids i32[B,S], lower/upper f32[B,D], pos i32[B,S])."""
    return BucketedPoints(_tensor(bp.pts, np.float32, device),
                          _tensor(bp.ids, np.int32, device),
                          _tensor(bp.lower, np.float32, device),
                          _tensor(bp.upper, np.float32, device),
                          _tensor(bp.pos, np.int32, device))


def candidate_state(st, device="cpu") -> CandidateState:
    """The port's ``CandidateState`` from (dist2 f32[Q,k], idx i32[Q,k])."""
    return CandidateState(_tensor(st.dist2, np.float32, device),
                          _tensor(st.idx, np.int32, device))


def kd_tree(tree, tree_ids, device="cpu"):
    """The port's kd-tree ``(tree f32[N, 3], tree_ids i32[N])`` from the
    JAX package's ``build_tree`` output, for ``ops/traverse.py``
    ``knn_update_tree``."""
    return (_tensor(tree, np.float32, device),
            _tensor(tree_ids, np.int32, device))
