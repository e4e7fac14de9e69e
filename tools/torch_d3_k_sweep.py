"""The D=3 kernels' time across k, on both designs of the fold.

Times by CUDA events one launch of each D=3 kernel on ``chip_smoke.py``
phase 4's 1,000,000 seeded uniform points: the traversal's one fold of a
1-shard run after the warm start (``launch_knn_tiled``, as phase 6 times
it) and the flat fold of the first 65,536 points against all of them
(``launch_knn_bf``), at each k asked for, on each design that takes it:

- ``slots``: the warp fold's instances of slots a lane
  (``knn_tiled_d3_kernel``, ``knn_bf_d3_kernel``), at the k they take (up
  to ``D3_SLOTS_MAX_K``, 4 slots a lane; the launchers refuse more);
- ``wide``: the wide fold (``knn_tiled_d3_wide_kernel``,
  ``knn_bf_d3_wide_kernel``) at every k, from a copy of the kernels built
  here with ``kSlotsMaxK`` 0 so that their launchers take it at any k.

Each design's plan is the package's own (for ``wide`` with
``D3_SLOTS_MAX_K`` 0), so the two designs compare at every k up to
``D3_SLOTS_MAX_K``, and the wide fold's time reads off the table above
it. Prints one JSON line a launch, with the warps its plan keeps on an SM
as the card reports them, and writes them all to ``--out``, beside the
card's name and power limit. Needs one CUDA card and ``nvcc``:

    python3 tools/torch_d3_k_sweep.py [--k 100,256,...] [--flat-k ...]
        [--out FILE.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (the phases' data and helpers)

FLAT_QUERIES = 65_536
K_DEFAULT = ("64,100,128,129,160,192,224,256,257,384,512,513,640,768,903,904,"
             "1000,2048")
OUT_DIR = ROOT / "build" / "d3_k_sweep"


def wide_everywhere_libraries():
    """Both kernels' libraries built from a copy of ``csrc/`` whose
    ``kSlotsMaxK`` is 0 (two nvcc at once): (knn_tiled, knn_bf)."""
    from mpi_cuda_largescaleknn_torch.utils.cuda_build import (
        CSRC,
        NVCC_FLAGS,
        _nvcc,
    )

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for src in CSRC.iterdir():
        text = src.read_text()
        if src.name == "knn_rows.cuh":
            text, n = re.subn(r"constexpr int kSlotsMaxK = \d+;",
                              "constexpr int kSlotsMaxK = 0;", text)
            if n != 1:
                raise SystemExit("kSlotsMaxK not found in knn_rows.cuh")
        (OUT_DIR / src.name).write_text(text)
    procs = {}
    for name in ("knn_tiled", "knn_bf"):
        lib = OUT_DIR / f"{name}_wide.so"
        procs[name] = (lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(OUT_DIR), "-o", str(lib),
             str(OUT_DIR / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = []
    for name, (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{out}")
        libs.append(ctypes.CDLL(str(path)))
    tiled, bf = libs
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import _SIGNATURES

    for fn_name, sig in _SIGNATURES["knn_tiled"].items():
        fn = getattr(tiled, fn_name)
        fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                       for c in sig]
        fn.restype = ctypes.c_int
    bf.knn_bf_launch.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    bf.knn_bf_launch.restype = ctypes.c_int
    bf.knn_bf_blocks_per_sm.argtypes = [ctypes.c_int] * 3
    bf.knn_bf_blocks_per_sm.restype = ctypes.c_int
    return tiled, bf


@contextmanager
def design(name, wide_libs):
    """The package planning and launching one design: as it is
    (``slots``, up to ``D3_SLOTS_MAX_K``), or with ``D3_SLOTS_MAX_K`` 0 on
    the copy whose launchers take the wide fold at every k (``wide``)."""
    from mpi_cuda_largescaleknn_torch.ops import knn_bf as tb
    from mpi_cuda_largescaleknn_torch.ops import knn_tiled as tk

    saved = tk.D3_SLOTS_MAX_K, tk._library, tb._library
    if name == "wide":
        tk.D3_SLOTS_MAX_K = 0
        tk._library = lambda lib_name: wide_libs[0]
        tb._library = lambda: wide_libs[1]
    try:
        yield
    finally:
        tk.D3_SLOTS_MAX_K, tk._library, tb._library = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", default=K_DEFAULT,
                    help="k of the traversal's launches")
    ap.add_argument("--flat-k", default=K_DEFAULT,
                    help="k of the flat fold's launches")
    ap.add_argument("--out", default="", help="JSON file of the results")
    args = ap.parse_args(argv)

    import torch

    from mpi_cuda_largescaleknn_torch.core.types import CandidateState
    from mpi_cuda_largescaleknn_torch.ops.candidates import init_candidates
    from mpi_cuda_largescaleknn_torch.ops.knn_bf import (
        flat_d3_plan,
        launch_knn_bf,
        resident_warps,
    )
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        D3_SLOTS_MAX_K,
        d3_resident_warps,
        d3_slots,
        launch_knn_tiled,
        tiled_launch_plan,
    )
    from mpi_cuda_largescaleknn_torch.ops.partition import (
        coarsen_buckets,
        nearest_first_order,
        partition_points,
    )
    from mpi_cuda_largescaleknn_torch.ops.tiled import warm_start_self

    if not torch.cuda.is_available():
        print("no CUDA card: the kernels have no CPU mode", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    wide_libs = wide_everywhere_libraries()
    pts = torch.from_numpy(smoke.seeded_points(
        "uniform", smoke.N_MAIN, smoke.SEED + 2)).cuda()
    q = partition_points(pts, bucket_size=256)
    pc = coarsen_buckets(q, 2)
    sorted_d2, order = nearest_first_order(q.lower, q.upper, pc.lower,
                                           pc.upper)
    results = []

    def report(rec):
        rec.update(card=smi, slots_a_lane=d3_slots(rec["k"]))
        print(json.dumps(rec), flush=True)
        results.append(rec)

    def designs(k):
        return ("slots", "wide") if k <= D3_SLOTS_MAX_K else ("wide",)

    # each design's libraries built and loaded by an untimed launch of
    # both kernels first
    ids = torch.arange(len(pts), dtype=torch.int32, device=pts.device)
    for name in ("slots", "wide"):
        with design(name, wide_libs):
            warm = warm_start_self(pc, 8)
            launch_knn_tiled(order, sorted_d2, q, pc, warm, skip_self=True,
                             self_group=2)
            launch_knn_bf(pts[:1024], pts, ids,
                          init_candidates(1024, 8, device=pts.device))
    torch.cuda.synchronize()
    for k in (int(x) for x in args.k.split(",") if x):
        warm = warm_start_self(pc, k)
        for name in designs(k):
            with design(name, wide_libs):
                rows = CandidateState(warm.dist2.clone(), warm.idx.clone())
                ms, visits = smoke.cuda_ms(lambda: launch_knn_tiled(
                    order, sorted_d2, q, pc, rows, skip_self=True,
                    self_group=2))
                plan = tiled_launch_plan(q.bucket_size, pc.bucket_size, k, 3)
                report({"kernel": "traversal", "design": name, "k": k,
                        "ms": ms, "visits": int(visits.sum()),
                        "warps_per_sm": d3_resident_warps(
                            q.bucket_size, pc.bucket_size, k),
                        "plan": plan._asdict()})
                del rows
        del warm
        torch.cuda.empty_cache()
    for k in (int(x) for x in args.flat_k.split(",") if x):
        for name in designs(k):
            with design(name, wide_libs):
                rows = init_candidates(FLAT_QUERIES, k, device=pts.device)
                ms, _ = smoke.cuda_ms(lambda: launch_knn_bf(
                    pts[:FLAT_QUERIES], pts, ids, rows))
                report({"kernel": "flat", "design": name, "k": k, "ms": ms,
                        "shape": f"{FLAT_QUERIES} x {len(pts)}",
                        "warps_per_sm": resident_warps(k),
                        "plan": flat_d3_plan(2048, 2048, k)._asdict()})
                del rows
                torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
