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
