"""Run configuration and device selection.

``KnnConfig`` carries the reference's 5-flag CLI surface (``-k``, ``-r``,
``-g``, input, ``-o``) plus the port's own knobs.
"""

from __future__ import annotations

import dataclasses
import math

import torch

#: engines the port runs, the JAX package's six: ``auto`` resolves to
#: ``pallas_tiled``, the nearest-first traversal whose kernel is
#: ``csrc/knn_tiled.cu``; ``tiled`` is its XLA twin (``ops/tiled.py``);
#: ``pallas`` is the flat brute force of ``csrc/knn_bf.cu``,
#: ``bruteforce`` its XLA twin (``ops/brute_force.py``), and ``tree`` the
#: stack-free kd-tree traversal (``ops/traverse.py``, D=3 only)
ENGINES = ("auto", "tiled", "pallas_tiled", "bruteforce", "tree", "pallas")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without CUDA that raises: the port never
    falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class KnnConfig:
    # --- reference-parity knobs -------------------------------------------
    k: int = 0                       # `-k`; must be >= 1 to run
    max_radius: float = math.inf     # `-r`; candidates beyond this never enter
    device_affinity: int = 0         # `-g`; kept for CLI parity: one process
                                     # drives one card, rank 0 % g == 0

    # --- port knobs --------------------------------------------------------
    device: str | None = None        # None = "cuda"; "cpu" runs the plain
                                     # PyTorch versions of the kernels
    engine: str = "auto"             # one of ENGINES; "auto" =
                                     # "pallas_tiled"
    query_tile: int = 2048           # pallas / bruteforce: queries per tile
                                     # (the kernel's rows per block, clamped)
    point_tile: int = 2048           # pallas / bruteforce: points per tile
                                     # (the kernel's staged lanes, clamped)
    bucket_size: int = 0             # points per spatial bucket; 0 = auto
                                     # per engine (parallel/ring.py
                                     # resolve_bucket_size)
    point_group: int = 0             # coarsen the resident point side by
                                     # this power-of-two factor; 0 = auto
                                     # (2 for pallas_tiled, else 1)
    num_shards: int = 1              # virtual shards on the one card (0 =
                                     # 1, or one per pre-partitioned file)
    score_dtype: str = "f32"         # "f32" exact; "bf16" = matmul-form
                                     # scores + exact rescore at D >= 16
                                     # (pallas_tiled on the tensor cores,
                                     # tiled, bruteforce; pallas and tree
                                     # refuse it, the pre-partitioned
                                     # pipeline scores f32)
    profile_dir: str | None = None   # the CLIs trace the run with
                                     # torch.profiler into this directory
                                     # (obs/trace.py)
    query_chunk: int = 0             # >0: stream queries in chunks of this
                                     # many rows a shard (candidate rows
                                     # held for chunk*k per shard: the
                                     # k=100 memory wall)
    merge: str = "host"              # chunked runs: "host" (the ring per
                                     # chunk), "device" (every shard folds
                                     # the whole chunk, the R partial rows
                                     # merged on the card), "auto" (device
                                     # at a power-of-two shard count)
    checkpoint_dir: str | None = None  # round (or chunk) checkpoints and
                                     # resume (utils/checkpoint.py)
    checkpoint_every: int = 1        # rounds (chunks) between snapshots

    def validate(self) -> None:
        if self.k < 1:
            raise ValueError("no k specified, or invalid k value")
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine '{self.engine}'")
        if self.score_dtype not in ("f32", "bf16"):
            raise ValueError(f"unknown score_dtype '{self.score_dtype}' "
                             "(expected f32 | bf16)")
        if self.merge not in ("host", "device", "auto"):
            raise ValueError(f"unknown merge mode '{self.merge}' "
                             "(expected host | device | auto)")
        if self.query_chunk < 0 or self.checkpoint_every < 1:
            raise ValueError("query_chunk must be >= 0 and checkpoint_every "
                             f">= 1, got {self.query_chunk} and "
                             f"{self.checkpoint_every}")
        if self.num_shards < 0:
            raise ValueError(f"num_shards must be >= 0, got {self.num_shards}")
        if self.query_tile < 1 or self.point_tile < 1:
            raise ValueError("query_tile and point_tile must be >= 1, got "
                             f"{self.query_tile} and {self.point_tile}")
        pg = self.point_group
        if pg < 0 or (pg and (pg & (pg - 1)) != 0):
            raise ValueError(
                "point_group must be 0 (auto) or a power of two >= 1, "
                f"got {pg}")
