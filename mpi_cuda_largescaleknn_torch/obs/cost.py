"""Analytic cost model: executed distance work -> FLOPs -> MFU estimate.

The port of the JAX package's ``obs/cost.py``: the same unit of work, the
same report, the same ``LSK_PEAK_FLOPS`` override. The unit is one 3-D
squared-distance evaluation (``FLOPS_PER_PAIR`` = 3 sub + 3 mul + 2 add
= 8 f32 FLOPs); the engines report how many pairs they scored (the
batch CLIs' ``--timings`` ``pair_evals``).

The exact D=3 traversal scores on the FP32 lanes, not the tensor cores,
so MFU is measured against the card's FP32 peak. The candidate merge
(compares, inserts) is real work not counted here: the estimate is a
LOWER bound on achieved utilization.

The peak is looked up by the device kind the caller names
(``torch.cuda.get_device_name()``), falls back to the platform's, and
``LSK_PEAK_FLOPS`` (f32 FLOP/s) overrides both; every report carries the
assumed peak and the device kind, so nothing is presented as more
precise than it is.
"""

from __future__ import annotations

import os

FLOPS_PER_PAIR = 8  # 3 sub + 3 mul + 2 add per 3-D squared distance

# peak FP32 FLOP/s by device-kind substring (first match wins). H100 SXM5
# at its 700 W power limit: 67e12 FP32 FLOP/s (NVIDIA H100 data sheet:
# 132 SMs x 128 FP32 lanes x 2 (an FMA is two FLOPs) x 1.98 GHz). A card
# set below 700 W may clock lower under load; LSK_PEAK_FLOPS overrides.
_PEAK_BY_KIND = (
    ("h100", 67e12),
)

# platform-level fallback when no device kind matches
_PEAK_F32 = {
    "gpu": 67e12,    # the H100 SXM5 figure above, the port's one card
    "cpu": 1.0e11,   # one AVX-ish host core pool, for labeled fallbacks
}


def peak_flops(platform: str, device_kind: str | None = None) -> float:
    env = os.environ.get("LSK_PEAK_FLOPS")
    if env:
        return float(env)
    if device_kind:
        low = device_kind.lower()
        for frag, peak in _PEAK_BY_KIND:
            if frag in low:
                return peak
    return _PEAK_F32.get(platform, _PEAK_F32["gpu"])


def cost_report(pair_evals: int, seconds: float, platform: str,
                device_kind: str | None = None) -> dict:
    """{device flop estimate, pair-eval throughput, MFU vs FP32 peak}."""
    flops = pair_evals * FLOPS_PER_PAIR
    peak = peak_flops(platform, device_kind)
    return {
        "pair_evals": int(pair_evals),
        "pair_evals_per_sec": round(pair_evals / seconds, 1) if seconds else 0.0,
        "distance_flops": int(flops),
        "assumed_peak_flops": peak,
        "device_kind": device_kind or platform,
        "mfu_estimate": round(flops / seconds / peak, 4) if seconds else 0.0,
    }
