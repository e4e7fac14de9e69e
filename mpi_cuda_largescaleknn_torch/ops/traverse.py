"""Stack-free kd-tree traversal kNN engine: the engine ``tree``.

The port of the JAX package's ``ops/traverse.py`` (the reference's
``cukd::stackFree::knn``), as PyTorch ops: the implicit left-balanced tree
of ``ops/build_tree.py`` is walked with parent/child index arithmetic only,
visiting a node's point when first arriving from its parent, descending to
the close child first, entering the far child only while the splitting
plane is closer than the query's current k-th candidate, and otherwise
ascending. All queries advance one automaton step at a time in lockstep,
carrying (curr, prev) index vectors and the candidate rows; a finished
query idles at ``curr == -1``.

The loop runs until no query is active. A step taken after every query has
finished changes nothing (an idle query stays idle), so the host reads the
predicate once every ``LIVENESS_EVERY`` steps instead of every step, with
the same bits: a read per step would cost more than the step on the card.
"""

from __future__ import annotations

import warnings

import torch

from mpi_cuda_largescaleknn_torch.core.types import CandidateState
from mpi_cuda_largescaleknn_torch.ops.build_tree import node_depth

#: tree points a shard above which the JAX package warns that the lockstep
#: automaton's divergence makes it slow against the tiled engines
_TREE_WARN_N = 200_000
#: steps between the host's reads of "is any query still active"
LIVENESS_EVERY = 32


def _insert_sorted(row_d2, row_idx, d2, idx, do_insert):
    """Insert one candidate into each ascending row where it beats the row's
    worst slot strictly (the heap's cutoff semantics), after every equal
    entry."""
    k = row_d2.shape[-1]
    do_insert = do_insert & (d2 < row_d2[:, -1])
    pos = (row_d2 < d2[:, None]).sum(dim=1, keepdim=True)
    cols = torch.arange(k, device=row_d2.device)[None, :]
    shifted_d2 = torch.cat([row_d2[:, :1], row_d2[:, :-1]], dim=1)
    shifted_idx = torch.cat([row_idx[:, :1], row_idx[:, :-1]], dim=1)
    new_d2 = torch.where(cols < pos, row_d2,
                         torch.where(cols == pos, d2[:, None], shifted_d2))
    new_idx = torch.where(cols < pos, row_idx,
                          torch.where(cols == pos, idx[:, None], shifted_idx))
    keep = ~do_insert[:, None]
    return (torch.where(keep, row_d2, new_d2),
            torch.where(keep, row_idx, new_idx))


def knn_update_tree(state: CandidateState, queries: torch.Tensor,
                    tree: torch.Tensor, tree_ids: torch.Tensor | None = None,
                    **_unused_tiling) -> CandidateState:
    """Fold every tree point into the candidate rows by the stack-free
    traversal (module docstring), on the device the tensors are on.
    ``tree`` f32[N, 3] in the implicit layout of ``build_tree``, its ids
    i32[N] (default ``arange(N)``); queries f32[Q, 3], state [Q, k]. The
    squared distance is ``(dx*dx + dy*dy) + dz*dz``, each operation
    rounded on its own. Raises ValueError unless D is 3; warns above
    ``_TREE_WARN_N`` points. Counts its steps in ``knn_update_tree.steps``
    and its calls in ``.folds``."""
    n = tree.shape[0]
    if n == 0:
        return state
    if tree.shape[-1] != 3 or queries.shape[-1] != 3:
        raise ValueError(f"engine 'tree' takes points of D=3, got tree "
                         f"{tuple(tree.shape)}, queries "
                         f"{tuple(queries.shape)}")
    if n > _TREE_WARN_N:
        warnings.warn(
            f"engine 'tree' with {n} points per shard: the lockstep "
            "traversal automaton degrades badly at this size (divergence "
            "padding) — use engine 'tiled' / 'pallas_tiled' / 'auto'",
            RuntimeWarning, stacklevel=2)
    dev = tree.device
    if tree_ids is None:
        tree_ids = torch.arange(n, dtype=torch.int32, device=dev)
    queries = queries.to(torch.float32)
    split_dim = (node_depth(torch.arange(n, device=dev)) % 3).long()

    curr = torch.zeros(queries.shape[0], dtype=torch.int32, device=dev)
    prev = curr - 1
    hd2, hidx = state
    step = 0
    while step % LIVENESS_EVERY or bool((curr >= 0).any()):
        active = curr >= 0
        safe = torch.clamp(curr, 0, n - 1).long()
        node_pt = tree[safe]                                     # [Q, 3]
        node_id = tree_ids[safe]
        parent = torch.where(curr > 0, (curr - 1) // 2, -1)

        from_parent = prev < curr
        dx = queries[:, 0] - node_pt[:, 0]
        dy = queries[:, 1] - node_pt[:, 1]
        dz = queries[:, 2] - node_pt[:, 2]
        d2 = (dx * dx + dy * dy) + dz * dz
        hd2, hidx = _insert_sorted(hd2, hidx, d2, node_id,
                                   active & from_parent)

        dim = split_dim[safe][:, None]
        sd = (torch.gather(queries, 1, dim)
              - torch.gather(node_pt, 1, dim))[:, 0]
        go_right = (sd >= 0).to(torch.int32)
        close = 2 * curr + 1 + go_right
        far = 2 * curr + 2 - go_right
        # the far child only if the splitting plane is closer than the
        # k-th candidate and the child exists
        after_close = torch.where((sd * sd < hd2[:, -1]) & (far < n), far,
                                  parent)
        nxt = torch.where(from_parent,
                          torch.where(close < n, close, after_close),
                          torch.where(prev == close, after_close, parent))
        prev = torch.where(active, curr, prev)
        curr = torch.where(active, nxt, curr)
        step += 1
    knn_update_tree.steps += step
    knn_update_tree.folds += 1
    return CandidateState(hd2, hidx)


knn_update_tree.steps = 0
knn_update_tree.folds = 0
