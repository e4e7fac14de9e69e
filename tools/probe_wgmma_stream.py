"""Where the bf16 ``wgmma`` kernel's streamed route spends its time.

Builds variants of ``mpi_cuda_largescaleknn_torch/csrc/knn_tiled_mxu.cu``
that each take one part of the work away, and times every variant by CUDA
events over one launch of ``launch_knn_tiled_mxu`` (the kernel alone, as
``chip_smoke.py`` phase 11b times it) at two shapes: phase 11b's (65,536
clustered points, D=600, k=10) and phase 10c's (262,144 clustered points,
D=960, k=10), each after its warm start. The variants:

- the walk free (the kernel's own prune and adoption): ``base``, and with
  the products or the copies quartered. Quartering changes the scores, so
  it changes the walk too: the visits are printed beside each time.
- the walk fixed: the prune and the adoption switched off, so every block
  walks all its point buckets and every variant does the same walk.
  ``base``; ``products/4`` (one k-step a slice in place of up to four);
  ``copies/4`` (a quarter of each stage's query and point slices copied);
  ``no products`` (no k-step, the commit and wait kept); ``no copies``
  (the stage's barrier completes with no slice copied, its ``|p|^2``
  kept); ``skeleton`` (neither): what the barriers, turns and gate cost.

Variants whose scores are wrong give wrong rows; only times are read. Each
edit of the source must match once, so an edited kernel fails loudly here.
Needs one CUDA card and ``nvcc``:

    python3 tools/probe_wgmma_stream.py [--reps 2] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (the phases' data and helpers)

SOURCE = ROOT / "mpi_cuda_largescaleknn_torch" / "csrc" / "knn_tiled_mxu.cu"
OUT_DIR = ROOT / "build" / "probe_wgmma_stream"

_PRUNE = "    if (!(__shfl_sync(0xffffffffu, bx[v], 0) < worst)) break;\n"
_ADOPT = "if (__any_sync(0xffffffffu, (m[0] | m[1]) != 0u)) adopt(sc, m, pos0);"
_KSTEPS = "wgmma_desc(st + 3 * part, sbo_g), g / 16, c0);"
_BYTES = "const uint32_t bytes = kWgRows * min(slice, dp - c0) * 2;"
_COPIES = """            bulk_load(st, qh + qoff + e, bytes, full + s);
            bulk_load(st + part, ql + qoff + e, bytes, full + s);
            bulk_load(st + 2 * part, ph + poff + e, bytes, full + s);
            bulk_load(st + 3 * part, pl + poff + e, bytes, full + s);
"""

#: (old, new) edits of the source, each matching once
EDITS = {
    # pos0 is never negative, but the compiler cannot know: the gate's
    # scores are still computed and tested, nothing is adopted
    "fixed": [(_PRUNE, ""),
              (_ADOPT, _ADOPT.replace(")) adopt", ") && pos0 < 0) adopt"))],
    "products/4": [(_KSTEPS, _KSTEPS.replace("g / 16", "(g + 63) / 64"))],
    "copies/4": [(_BYTES, _BYTES.replace("* 2;", "* 2 / 4;"))],
    "no products": [(_KSTEPS, _KSTEPS.replace("g / 16", "0"))],
    "no copies": [(_BYTES, "const uint32_t bytes = 0;"),
                  (_COPIES, "            if (bytes) {\n" + _COPIES
                   + "            }\n")],
}

#: (walk, name, edits)
VARIANTS = [
    ("free", "base", []),
    ("free", "products/4", ["products/4"]),
    ("free", "copies/4", ["copies/4"]),
    ("fixed", "base", ["fixed"]),
    ("fixed", "products/4", ["fixed", "products/4"]),
    ("fixed", "copies/4", ["fixed", "copies/4"]),
    ("fixed", "no products", ["fixed", "no products"]),
    ("fixed", "no copies", ["fixed", "no copies"]),
    ("fixed", "skeleton", ["fixed", "no products", "no copies"]),
]


def variant_source(edits) -> str:
    text = SOURCE.read_text()
    for edit in edits:
        for old, new in EDITS[edit]:
            if text.count(old) != 1:
                raise SystemExit(f"edit {edit!r}: {text.count(old)} "
                                 f"matches of {old.strip()!r}")
            text = text.replace(old, new)
    return text


def build_all():
    """Compile every variant at once (one nvcc each); returns their
    libraries, loaded, in VARIANTS order."""
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import _SIGNATURES
    from mpi_cuda_largescaleknn_torch.utils.cuda_build import (
        NVCC_FLAGS,
        _nvcc,
    )

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (_, _, edits) in enumerate(VARIANTS):
        src = OUT_DIR / f"variant{i}.cu"
        src.write_text(variant_source(edits))
        lib = OUT_DIR / f"variant{i}.so"
        procs.append((lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(SOURCE.parent), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = []
    for (walk, name, _), (path, proc) in zip(VARIANTS, procs):
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {walk} {name}:\n{out}")
        regs = [ln.split(":", 1)[1].strip() for ln in out.splitlines()
                if ": Used " in ln]
        print(f"  built {walk} walk, {name}: {' | '.join(regs)}")
        lib = ctypes.CDLL(str(path))
        for fn_name, sig in _SIGNATURES["knn_tiled_mxu"].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                           for c in sig]
            fn.restype = ctypes.c_int
        libs.append(lib)
    return libs


def shape(n, dim, seed):
    """Phase 11b's set-up at (n, dim): buckets, warm rows widened, walk."""
    import torch

    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        mxu_launch_geometry,
        survivor_width,
        widen_rows,
    )
    from mpi_cuda_largescaleknn_torch.ops.partition import (
        coarsen_buckets,
        nearest_first_order,
        partition_points,
    )
    from mpi_cuda_largescaleknn_torch.ops.tiled import warm_start_self

    pts = torch.from_numpy(smoke.clustered_nd(n, dim, seed)).cuda()
    q = partition_points(pts, bucket_size=256)
    pc = coarsen_buckets(q, 2)
    start = widen_rows(warm_start_self(pc, smoke.HD_K),
                       survivor_width(smoke.HD_K, pc))
    sorted_d2, order = nearest_first_order(q.lower, q.upper, pc.lower,
                                           pc.upper)
    plan = mxu_launch_geometry(dim, start.dist2.shape[1])
    if plan.kernel != "wgmma_stream":
        raise SystemExit(f"D={dim} planned {plan.kernel}")
    return dict(q=q, pc=pc, start=start, order=order, sorted_d2=sorted_d2,
                plan=plan, dim=dim, n=n)


def launch_ms(lib, case):
    """One launch of ``launch_knn_tiled_mxu`` on ``lib``'s kernel; returns
    (kernel ms by CUDA events, visits i32[Bq])."""
    import torch

    from mpi_cuda_largescaleknn_torch.core.types import CandidateState
    from mpi_cuda_largescaleknn_torch.ops import knn_tiled as tk

    rows = CandidateState(case["start"].dist2.clone(),
                          case["start"].idx.clone())
    events = []
    tk.knn_update_tiled_cuda.mxu_events = events
    saved = tk._library
    tk._library = lambda name: lib
    try:
        visits = tk.launch_knn_tiled_mxu(
            case["order"], case["sorted_d2"], case["q"], case["pc"], rows,
            skip_self=True, self_group=2)
    finally:
        tk._library = saved
        tk.knn_update_tiled_cuda.mxu_events = None
    torch.cuda.synchronize()
    return events[0][1].elapsed_time(events[0][2]), visits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=str(OUT_DIR / "probe.json"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this probe times a CUDA kernel")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    libs = build_all()
    print(f"  {len(libs)} variants built in {time.perf_counter() - t0:.1f} s")
    res = {"device": smi, "reps": args.reps, "shapes": {}}
    for n, dim, seed in ((65_536, 600, smoke.SEED + 30 + 600),
                         (smoke.HD_SUB, smoke.GIST_DIM, smoke.SEED + 6)):
        case = shape(n, dim, seed)
        plan, q, pc = case["plan"], case["q"], case["pc"]
        blocks = -(-q.bucket_size // 128)
        pair_chunks = -(-pc.bucket_size // 128)
        for lib in libs:  # the first launch of each loads its module
            launch_ms(lib, case)
        times = {i: [] for i in range(len(VARIANTS))}
        visits = {}
        for _ in range(args.reps):  # variants interleaved
            for i, lib in enumerate(libs):
                ms, vis = launch_ms(lib, case)
                times[i].append(ms)
                visits[i] = vis
        out = {"N": n, "D": dim, "plan": plan._asdict(), "variants": []}
        print(f"D={dim}, N={n}: plan {plan}")
        for i, (walk, name, _) in enumerate(VARIANTS):
            vis = visits[i]
            pairs = smoke.visited_pairs(case["order"], vis, q, pc)
            # every block of a bucket walks its visits (the most any of
            # them did: exact on the fixed walk, at most on the free one)
            stages_bytes = (int(vis.sum()) * blocks * pair_chunks
                            * (4 * 128 * plan.dp * 2 + 2 * 64 * 4))
            ms = min(times[i])
            row = {"walk": walk, "variant": name, "ms": times[i],
                   "visits": int(vis.sum()), "pairs": pairs,
                   "tensor_term_ms": pairs * 6 * dim / smoke.PEAK_BF16 * 1e3,
                   "stage_bytes_unedited": stages_bytes,
                   "stage_TBps_unedited": stages_bytes / ms / 1e9}
            out["variants"].append(row)
            print(f"  walk {walk:5s} {name:12s} "
                  + " / ".join(f"{t:.3f}" for t in times[i])
                  + f" ms, visits {row['visits']}, pairs {pairs}, "
                  f"tensor term {row['tensor_term_ms']:.3f} ms "
                  f"({100 * row['tensor_term_ms'] / ms:.1f}%), stages "
                  f"{stages_bytes:.4e} B unedited "
                  f"({row['stage_TBps_unedited']:.2f} TB/s)")
        res["shapes"][f"D{dim}"] = out
        del case
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
