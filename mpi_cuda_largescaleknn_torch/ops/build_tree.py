"""Left-balanced implicit kd-tree construction: the tree of the engine
``tree``.

The port of the JAX package's ``ops/build_tree.py`` (the reference's
``cukd::buildTree``): the reordered point array IS the tree. Node i's
children are 2i+1 and 2i+2, every node is a point, and the split dimension
is round-robin by depth. Once per tree level every point is sorted by
(node tag, coordinate along level % 3), stably; in each tag's segment the
point at the left-balanced pivot rank keeps the tag (it becomes the node),
those before it take the left child's tag and those after it the right
child's. Finally each point is scattered to the slot its tag names.

The tree has three coordinates. The JAX package's ``build_tree`` writes
only the first three columns of wider points (and its traversal scores
only them); the port refuses any other D.
"""

from __future__ import annotations

import torch


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of i64 values 1 <= x < 2**32, by shifts (a float
    ``log2`` rounds ``log2(2**24 - 1)`` up to 24 in f32)."""
    r = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << s)
        x = torch.where(big, x >> s, x)
        r = r + torch.where(big, s, 0)
    return r


def left_subtree_size(n: torch.Tensor) -> torch.Tensor:
    """Nodes in the left subtree of a complete left-balanced binary tree
    of ``n`` nodes, i32: with h = floor(log2(n)) and half = 2**(h-1),
    ``(half - 1) + clamp(n - (2*half - 1), 0, half)``; 0 for n <= 1."""
    n = n.to(torch.int64)
    h = _floor_log2(torch.clamp_min(n, 1))
    half = torch.where(h >= 1, 1 << torch.clamp_min(h - 1, 0), 0)
    f = (half - 1) + torch.minimum(torch.clamp_min(n - (2 * half - 1), 0),
                                   half)
    return torch.where(n <= 1, 0, f).to(torch.int32)


def node_depth(i: torch.Tensor) -> torch.Tensor:
    """Depth of node index ``i`` in the implicit tree, floor(log2(i + 1)),
    i32 (``i + 1`` taken in i64, where the JAX package's i32 sum wraps at
    i = 2**31 - 1 to a value whose depth is the same 31)."""
    return _floor_log2(i.to(torch.int64) + 1).to(torch.int32)


def build_tree(points: torch.Tensor, point_ids: torch.Tensor | None = None):
    """The implicit left-balanced kd-tree of ``points`` f32[N, 3] (sentinel
    padding rows allowed: they are far-away points in far subtrees), with
    their ids i32[N] (default ``arange(N)``) carried along. Returns
    ``(tree f32[N, 3], tree_ids i32[N])``: ``tree[i]`` is node i's point.
    Raises ValueError unless D is 3.

    A level's stable two-key sort is a stable sort by the coordinate, then
    a stable sort by the tag. The coordinate key is ``coord + 0.0``, so
    ``-0.0`` and ``0.0`` compare equal and keep their input order, as in
    ``lax.sort``, whatever the device's sort does with signed zeros."""
    points = torch.as_tensor(points, dtype=torch.float32)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"engine 'tree' takes points of D=3, got shape "
                         f"{tuple(points.shape)} (the JAX package's tree "
                         "scores only the first three coordinates)")
    n_total = points.shape[0]
    dev = points.device
    if point_ids is None:
        point_ids = torch.arange(n_total, dtype=torch.int32, device=dev)
    ids = torch.as_tensor(point_ids, dtype=torch.int32, device=dev)
    if n_total == 0:
        return points, ids
    num_levels = n_total.bit_length()     # ceil(log2(N + 1))

    tags = torch.zeros(n_total, dtype=torch.int32, device=dev)
    xyz = [points[:, 0], points[:, 1], points[:, 2]]
    positions = torch.arange(n_total, dtype=torch.int64, device=dev)
    for level in range(num_levels):
        key = xyz[level % 3] + 0.0
        perm = torch.sort(key, stable=True).indices
        perm = perm[torch.sort(tags[perm], stable=True).indices]
        tags = tags[perm]
        xyz = [c[perm] for c in xyz]
        ids = ids[perm]
        seg_start = torch.searchsorted(tags, tags, side="left")
        seg_end = torch.searchsorted(tags, tags, side="right")
        rank = positions - seg_start
        pivot = left_subtree_size(seg_end - seg_start)
        active = tags >= (1 << level) - 1   # this level's segments
        new_tags = torch.where(rank < pivot, 2 * tags + 1,
                               torch.where(rank == pivot, tags, 2 * tags + 2))
        tags = torch.where(active, new_tags, tags)

    slot = tags.long()
    tree = torch.zeros_like(points)
    for c in range(3):
        tree[slot, c] = xyz[c]
    tree_ids = torch.zeros_like(ids)
    tree_ids[slot] = ids
    return tree, tree_ids
