"""The plain reference and the comparison that decides ``correct``.

``kth_distances`` is the exact distance from each query to its k-th nearest
point of a set (the query itself counts when it is in the set, at distance
0), worked out again from the points the benchmark handed to the port: every
distance, in blocks of points, the k smallest kept by ``torch.topk``. It
computes in float64 by default, so its answer is the exact one to well
below float32's rounding. ``precision`` picks the lower precisions the
controls use: ``"bf16"`` (coordinates and arithmetic in bfloat16) and
``"tf32"`` (float32 in the matrix-product form, with TF32 on).

Imports torch and numpy only: nothing of the port, nothing of JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: distances above this dimension go through a matrix product
#: (|q|^2 + |p|^2 - 2 q.p); at or below it, elementwise (q - p)^2 sums
MATMUL_MIN_DIM = 8


def _block_d2(q: torch.Tensor, p: torch.Tensor, matmul: bool
              ) -> torch.Tensor:
    if matmul:
        d2 = (q * q).sum(1, keepdim=True) + (p * p).sum(1)[None, :]
        d2.sub_(2.0 * (q @ p.t()))
        return d2.clamp_(min=0)
    d2 = (q[:, None, 0] - p[None, :, 0]).square_()
    for i in range(1, q.shape[1]):
        d2.add_((q[:, None, i] - p[None, :, i]).square_())
    return d2


def kth_distances(points: torch.Tensor, queries: torch.Tensor, k: int, *,
                  precision: str = "f64", block_elems: int = 1 << 27
                  ) -> np.ndarray:
    """float64[Q]: each query's distance to its k-th nearest of ``points``
    (f32[N, D], on the device that computes), inf where N < k."""
    dtype = {"f64": torch.float64, "tf32": torch.float32,
             "bf16": torch.bfloat16}[precision]
    dim = points.shape[1]
    matmul = dim > MATMUL_MIN_DIM
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        q = queries.to(points.device, dtype)
        nq = q.shape[0]
        best = torch.full((nq, k), math.inf, dtype=dtype,
                          device=points.device)
        block = max(1024, block_elems // max(1, nq))
        with torch.no_grad():
            for lo in range(0, points.shape[0], block):
                d2 = _block_d2(q, points[lo:lo + block].to(dtype), matmul)
                both = torch.cat([best, d2], 1)
                best = torch.topk(both, k, dim=1, largest=False).values
                del d2, both
        kth = best.max(dim=1).values.double()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return np.sqrt(kth.cpu().numpy())


def compare(got: np.ndarray, want: np.ndarray) -> dict:
    """The numbers a cell's check compares: ``kth_rel_err_max``, the widest
    relative gap |got - want| / want over the answers both sides give as
    finite, and ``answers_bad``, the answers that are missing, not finite
    where the reference's is, or finite where it is not. Answers of the
    wrong count are all bad, at a gap of 1."""
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    if got.shape != want.shape:
        return {"kth_rel_err_max": 1.0, "answers_bad": len(want)}
    fin_w = np.isfinite(want)
    bad = int(np.count_nonzero(np.isfinite(got) != fin_w))
    both = fin_w & np.isfinite(got)
    if both.any():
        denom = np.maximum(want[both], np.finfo(np.float32).tiny)
        rel = float(np.max(np.abs(got[both] - want[both]) / denom))
    else:
        rel = 0.0
    return {"kth_rel_err_max": rel, "answers_bad": bad}
