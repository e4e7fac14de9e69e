"""Seeded point sets, drawn on the device.

Every set comes from its own ``torch.Generator`` on the device, seeded from
(the run's seed, a stream name, an index), so the same seed gives the same
points and a job's points can be drawn again after the window for the
reference. A configuration's ``points`` entry names the distribution:

- ``{"kind": "uniform", "dim": D}``: uniform in [0, 1)^D;
- ``{"kind": "clustered", "dim": D, "clusters": C, "center_sigma": s,
  "sigma": t}``: C Gaussian clusters, centres N(0, s^2) per component,
  each point N(centre, t^2) per component. The layout (the centres and
  each point's cluster) comes from (stream, index) alone and the points'
  spread from the seed too, so every seed's job j has job j's layout.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch


def stream_seed(seed: int, *parts) -> int:
    """A 64-bit seed for (``seed``, ``parts``): strings by their CRC32."""
    words = [int(seed) % (1 << 64)]
    for p in parts:
        words.append(zlib.crc32(p.encode()) if isinstance(p, str)
                     else int(p) % (1 << 64))
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0])


def generator(device, seed: int, *parts) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *parts))
    return g


def draw_points(spec: dict, n: int, device, seed: int, *parts
                ) -> torch.Tensor:
    """f32[n, D] on ``device`` from the distribution ``spec``."""
    g = generator(device, seed, *parts)
    dim = int(spec["dim"])
    if spec["kind"] == "uniform":
        return torch.rand((n, dim), generator=g, device=device,
                          dtype=torch.float32)
    if spec["kind"] == "clustered":
        c = int(spec["clusters"])
        # the layout (centres, and which cluster each point joins) from the
        # stream alone, the points around it from the seed: the work of a
        # job follows its layout, so every seed does the same work
        gl = generator(device, 0, "layout", *parts)
        centers = torch.randn((c, dim), generator=gl, device=device,
                              dtype=torch.float32) * float(spec["center_sigma"])
        labels = torch.randint(0, c, (n,), generator=gl, device=device)
        pts = torch.randn((n, dim), generator=g, device=device,
                          dtype=torch.float32)
        pts.mul_(float(spec["sigma"])).add_(centers[labels])
        return pts
    raise ValueError(f"unknown point distribution {spec['kind']!r}")


def host_points(spec: dict, n: int, device, seed: int, *parts) -> np.ndarray:
    """``draw_points`` copied to a host f32 array, as a user hands it over."""
    return draw_points(spec, n, device, seed, *parts).cpu().numpy()


def sample_rows(n: int, count: int, seed: int, *parts) -> np.ndarray:
    """``count`` distinct row indices of ``n``, drawn from the seed,
    ascending."""
    rng = np.random.default_rng(stream_seed(seed, *parts))
    return np.sort(rng.choice(n, size=min(count, n), replace=False))
