"""The two pieces of the JAX package's ``serve/frontend.py`` that the
tiered slab pool (serve/slabpool.py) shares with the pod front end: the
certification slack and the canonical candidate fold.

The rest of that module is pod serving (the replicate and routed front
ends, their fan-outs and host servers), which is not ported yet (ROADMAP.md
Queue 1, pod serving).
"""

from __future__ import annotations

import numpy as np


def routing_cert_slack(dim: int) -> float:
    """Relative certification slack: a slab (or a pod's host) is only
    CERTIFIED skippable when ``lb * (1 - slack) > kth_dist2``. The box
    bound is computed in f64, but the engines score pairs in f32 with a
    relative error bounded by ~(D+2) * 2^-24 (one rounding per multiply or
    add of the D-term sum), so a point exactly ON a box face could score
    BELOW the exact bound. The slack therefore grows with the dimension:
    16 x the error-model bound with a 1e-5 floor. The non-strict ``<=``
    comparison keeps every exact-tie slab, which is what keeps tie ids
    bitwise equal to one engine over all the points."""
    return max(1e-5, 16.0 * (dim + 2) * 2.0 ** -24)


def fold_candidates(cur_d2, cur_idx, rows, d2, idx, k):
    """Fold one slab's candidate rows into the running per-query top-k
    under the canonical (dist2, id) total order, in numpy. Commutative and
    associative (ids are unique), so the order in which slabs complete can
    never change the folded bits; init slots (id -1) still win their ties
    at the radius cutoff, preserving the engines' strict-< adoption."""
    cat_d2 = np.concatenate([cur_d2[rows], np.asarray(d2, np.float32)],
                            axis=1)
    cat_idx = np.concatenate([cur_idx[rows], np.asarray(idx, np.int32)],
                             axis=1)
    order = np.lexsort((cat_idx, cat_d2), axis=1)[:, :k]
    cur_d2[rows] = np.take_along_axis(cat_d2, order, axis=1)
    cur_idx[rows] = np.take_along_axis(cat_idx, order, axis=1)
