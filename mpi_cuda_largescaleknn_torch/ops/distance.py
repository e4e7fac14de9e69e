"""Squared distances: the exact elementwise form and the matmul form.

Exact: components reduce in a fixed left-to-right order, so at D=3 the
value is the correctly-rounded ``((d0*d0 + d1*d1) + d2*d2)`` of every exact
scorer in the JAX package (its ``ops/distance.py`` guards each square
against fused multiply-add contraction). Eager PyTorch runs each multiply
and add as its own kernel, so nothing here is ever contracted; the CUDA
kernels spell the same tree with ``__fmul_rn``/``__fadd_rn``.

Matmul form (``score_dtype="bf16"``, the JAX package's ``score_mxu``):
``||q||^2 + ||p||^2 - 2 q.p`` with the cross term as three bf16 products
(the bf16x3 split hi.hi + hi.lo + lo.hi, f32 accumulation). Its
cancellation error is unbounded relative to the exact form, so its scores
only select survivors, which are rescored exactly before they are kept.
The settings ``mxu_min_dim`` and ``rescore_width`` read the same
``LSK_MXU_MIN_DIM`` / ``LSK_RESCORE_WIDTH`` overrides as the JAX package.
"""

from __future__ import annotations

import os

import torch

#: "f32" = exact elementwise (the default); "bf16" = matmul-form scores on
#: the tensor cores, then an exact f32 rescore of the survivors
SCORE_DTYPES = ("f32", "bf16")


def validate_score_dtype(score_dtype: str) -> str:
    if score_dtype not in SCORE_DTYPES:
        raise ValueError(f"unknown score_dtype '{score_dtype}' "
                         f"(expected one of {SCORE_DTYPES})")
    return score_dtype


def accumulate_sq(acc, di: torch.Tensor) -> torch.Tensor:
    """One square-accumulate step, ``acc + di*di``; ``acc=None`` starts
    the chain."""
    sq = di * di
    return sq if acc is None else acc + sq


def elementwise_dist2(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """f32[..., Q, D] x f32[..., T, D] -> f32[..., Q, T] exact squared
    distances, fixed left-to-right component order."""
    acc = None
    for i in range(q.shape[-1]):
        acc = accumulate_sq(acc, q[..., :, None, i] - p[..., None, :, i])
    return acc


def gathered_dist2(q: torch.Tensor, pg: torch.Tensor) -> torch.Tensor:
    """f32[..., Q, D] queries x f32[..., Q, W, D] points gathered per row
    -> f32[..., Q, W] exact squared distances, in ``elementwise_dist2``'s
    component order (so the same pair gets the same bits): the exact
    rescore of a row's survivors."""
    acc = None
    for i in range(q.shape[-1]):
        acc = accumulate_sq(acc, q[..., :, None, i] - pg[..., i])
    return acc


def norms2(pts: torch.Tensor) -> torch.Tensor:
    """f32[..., D] -> f32[...]: squared norm, left-to-right components
    (the exact ``||p||^2`` term of the matmul form)."""
    acc = None
    for i in range(pts.shape[-1]):
        acc = accumulate_sq(acc, pts[..., i])
    return acc


def mxu_min_dim() -> int:
    """Smallest D at which ``score_dtype="bf16"`` uses the matmul form;
    below it bf16 scores exactly. ``LSK_MXU_MIN_DIM`` overrides (default
    16, the JAX package's)."""
    try:
        v = int(os.environ.get("LSK_MXU_MIN_DIM", "") or 0)
    except ValueError:
        v = 0
    return v if v > 0 else 16


def rescore_width(k: int, t: int) -> int:
    """Survivor slots per row under bf16: ``max(2k, 16)`` (or
    ``LSK_RESCORE_WIDTH``), at least k and at most the ``t`` lanes."""
    try:
        w = int(os.environ.get("LSK_RESCORE_WIDTH", "") or 0)
    except ValueError:
        w = 0
    if w <= 0:
        w = max(2 * k, 16)
    return min(t, max(w, k))


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo) bf16 with ``hi + lo ~= x`` to ~16 mantissa bits;
    both round to nearest even."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def mxu_scores(q: torch.Tensor, p: torch.Tensor,
               pn2: torch.Tensor | None = None,
               qn2: torch.Tensor | None = None) -> torch.Tensor:
    """Approximate squared distances f32[..., Q, D] x f32[..., T, D] ->
    f32[..., Q, T] by the matmul form: ``(qn2 + pn2) - 2 * cross`` with the
    cross term as three f32 products of bf16-rounded halves. A product of
    two bf16 values is exact in f32, so only the order of accumulation
    differs from the tensor cores'. ``pn2``/``qn2`` take precomputed norms."""
    if qn2 is None:
        qn2 = norms2(q)
    if pn2 is None:
        pn2 = norms2(p)
    qh, ql = (h.to(torch.float32) for h in split_bf16(q))
    ph, pl = (h.to(torch.float32).transpose(-1, -2) for h in split_bf16(p))
    cross = (torch.matmul(qh, ph) + torch.matmul(qh, pl)
             + torch.matmul(ql, ph))
    return qn2[..., :, None] + pn2[..., None, :] - 2.0 * cross


def score_tile(q: torch.Tensor, p: torch.Tensor, pid: torch.Tensor, k: int,
               *, score_dtype: str = "f32", mask: torch.Tensor | None = None,
               pn2: torch.Tensor | None = None, skip_rescore: bool = False):
    """Score one distance tile, ready for ``merge_candidates``: the JAX
    package's ``score_tile``. ``q`` f32[..., Q, D], ``p`` f32[..., T, D],
    ``pid`` i32[..., T] (broadcast over the Q rows), ``mask`` bool
    broadcastable to [..., Q, T] (False lanes are +inf in both modes, also
    after the rescore), ``pn2`` optional f32[..., T] point norms.

    - f32 (also bf16 below ``mxu_min_dim()``, or where the survivor window
      would cover every lane): the exact tile, width T.
    - bf16: width ``rescore_width(k, T)``. The matmul-form scores pick the
      survivors (lower lane first among ties: a stable sort, as
      ``lax.top_k``), their lane positions are re-sorted ascending so the
      tile stays a subsequence of the lane order, and each survivor is
      rescored exactly (``gathered_dist2``).
    - ``skip_rescore`` (bf16 at D >= ``mxu_min_dim()``): the raw
      matmul-form scores at full width, clamped at 0.

    Returns ``(cand_d2, cand_idx)``."""
    validate_score_dtype(score_dtype)
    t = p.shape[-2]
    w = rescore_width(k, t)
    if (score_dtype == "f32" or q.shape[-1] < mxu_min_dim()
            or (w >= t and not skip_rescore)):
        d2 = elementwise_dist2(q, p)
        if mask is not None:
            d2 = torch.where(mask, d2, torch.inf)
        return d2, pid[..., None, :].expand(d2.shape)
    scores = mxu_scores(q, p, pn2=pn2)
    if mask is not None:
        scores = torch.where(mask, scores, torch.inf)
    if skip_rescore:
        return (torch.clamp_min(scores, 0.0),
                pid[..., None, :].expand(scores.shape))
    pos = torch.sort(scores, dim=-1, stable=True).indices[..., :w]
    pos = torch.sort(pos, dim=-1).values                     # [..., Q, W]
    dim = q.shape[-1]
    pg = torch.gather(p[..., None, :, :].expand(*scores.shape, dim), -2,
                      pos[..., None].expand(*pos.shape, dim))
    acc = gathered_dist2(q, pg)
    idx = torch.gather(pid[..., None, :].expand(scores.shape), -1, pos)
    if mask is not None:
        # a masked lane that survived only because too few lanes were live
        # stays +inf: its exact distance may be finite
        keep = torch.gather(mask.expand(scores.shape), -1, pos)
        acc = torch.where(keep, acc, torch.inf)
    return acc, idx
