"""The work a kernel's roofline share is counted on, and the card's peaks.

The counts come from the cell's shapes alone (points, dimension, k, rows
answered), never from what the port reports it scored, so they do not move
with the implementation. They count only what every exact implementation
of the kernel's job must do, so that a share cannot pass 100%:

- a self-join of n points in D dimensions at k reads each point once (D
  f32) and each candidate row (k entries of an f32 distance and an i32 id)
  once, and writes each row once; it scores at least n * k pairs, the pair
  of each point and each of its k neighbours;
- a served batch of ``rows`` queries reads each query once, the k
  neighbours of each (k points of D f32), and writes each answer's row
  once; it too scores at least rows * k pairs.

A pair costs 3D - 1 f32 operations (D subtractions, D products, D - 1
sums), issued without FMA: the kernels are built with ``-fmad=false``.
"""

from __future__ import annotations

#: NVIDIA H100 SXM, the data sheet's dense f32 rate, 67 TFLOP/s, counts an
#: FMA as two; without FMA one operation issues a lane a clock: half that
PEAK_F32_FMA_FREE = 33.5e12
#: NVIDIA H100 SXM 80 GB, HBM3
PEAK_HBM_BYTES = 3.35e12
ROW_ENTRY_BYTES = 8  # an f32 distance and an i32 id


def pair_ops(dim: int) -> int:
    return 3 * dim - 1


def selfjoin_work(n: int, dim: int, k: int) -> dict:
    return {"ops": n * k * pair_ops(dim),
            "bytes": n * dim * 4 + 2 * n * k * ROW_ENTRY_BYTES}


def served_work(rows: int, dim: int, k: int) -> dict:
    return {"ops": rows * k * pair_ops(dim),
            "bytes": rows * dim * 4 + rows * k * dim * 4
            + rows * k * ROW_ENTRY_BYTES}


def least_seconds(work: dict) -> tuple[float, str]:
    """(the least time the card could take, which bound sets it)."""
    t_ops = work["ops"] / PEAK_F32_FMA_FREE
    t_bytes = work["bytes"] / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def roofline_share(work: dict, seconds: float) -> float | None:
    """Percent of the roofline that ``seconds`` of kernel time reach; None
    where no kernel time was read."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * least_seconds(work)[0] / seconds
