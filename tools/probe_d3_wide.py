"""Where the D=3 wide fold spends its time, split by section.

Builds a copy of ``csrc/knn_tiled.cu`` and ``csrc/knn_bf.cu`` (with the
shared ``csrc/knn_rows.cuh``) whose wide fold reads the SM's clock at the
borders of its sections and adds the cycles, per warp, into counters, with
a count of merges, flushes, buffered lanes and rows beside them; the
kernels' own code is otherwise unchanged, so they give the same rows. Each
edit of the source must match once, so a changed kernel fails loudly here,
and each design of the fold has its own edits (``EDITS``). Times by CUDA
events one launch of the unedited kernel and one of the instrumented copy
at three shapes, on ``chip_smoke.py`` phase 4's 1,000,000 seeded uniform
points at k=1000:

- ``device_merge``: phase 21b's chunked device merge, one launch: a cold
  gathered chunk of 4 x 32,768 rows (one query bucket whose box spans the
  cube) against one of 4 shards' resident sides (``chunk_sides``);
- ``traversal``: phase 21d's fold of a 1-shard run after the warm start;
- ``flat``: phase 21b's flat fold, 1M x 1M, cold.

The split is of the warps' cycles: the share of all warps' resident time
each section took, which is the share of the kernel's time when every SM
holds as many warps throughout. Needs one CUDA card and ``nvcc``:

    python3 tools/probe_d3_wide.py [--root CHECKOUT] [--shapes a,b]
        [--out FILE.json]

``--root`` names the checkout whose package, kernels and ``chip_smoke.py``
it builds and drives (default: this one), so an older tree unpacked beside
it is split by the same script.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

SLOTS = 16
#: counter slots: cycles of each section summed over warps, then counts
NAMES = ["total", "tile", "row_fold", "sort", "walk", "flush", "merges",
         "flush_merges", "buffered", "rows", "tiles", "decisions",
         "lazy_flushes", "waits", "publish", ""]

_PROBE = """namespace knn {

// ---- probe counters (tools/probe_d3_wide.py) ----
__device__ unsigned long long g_probe[16];
__shared__ unsigned long long s_probe[16 * 16];
__device__ __forceinline__ void probe_add(int slot, long long v) {
  if ((threadIdx.x & 31) == 0) s_probe[(threadIdx.x >> 5) * 16 + slot] += v;
}
__device__ __forceinline__ void probe_begin() {
  if ((threadIdx.x & 31) == 0)
    for (int s = 0; s < 16; ++s) s_probe[(threadIdx.x >> 5) * 16 + s] = 0;
  __syncwarp();
}
__device__ __forceinline__ void probe_end() {
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    for (int s = 0; s < 16; ++s)
      atomicAdd(&g_probe[s], s_probe[(threadIdx.x >> 5) * 16 + s]);
}
"""

_READERS = """
extern "C" int knn_probe_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(knn::g_probe, z, sizeof z);
}
extern "C" int knn_probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, knn::g_probe, 16 * 8);
}
"""

_ROW_CALL_END = "pend.d[r], pend.id[r], pend.n[r]);\n"

#: design -> file -> [(old, new)]; each old text must match once
EDITS = {
    # the first wide fold: a pending buffer of 32 in registers, merged on
    # overflow (wide_merge: warp_sort, then the walk) and by wide_flush at
    # every tile's end; split with --root on a checkout that holds it
    "registers": {
        "knn_rows.cuh": [
            ("namespace knn {\n", _PROBE),
            ("  const int lane = threadIdx.x & 31;\n"
             "  float d = lane < n ? pd : CUDART_INF_F;\n",
             "  const long long pt0 = clock64();\n"
             "  const int lane = threadIdx.x & 31;\n"
             "  float d = lane < n ? pd : CUDART_INF_F;\n"),
            ("  warp_sort(d, key, id);\n",
             "  warp_sort(d, key, id);\n  const long long pt1 = clock64();\n"
             "  probe_add(3, pt1 - pt0);\n"),
            ("  __syncwarp();\n  return rd2[k - 1];\n",
             "  __syncwarp();\n  probe_add(4, clock64() - pt1);\n"
             "  probe_add(6, 1);\n  return rd2[k - 1];\n"),
            ("    pn += __popc(m);\n",
             "    probe_add(8, __popc(m));\n    pn += __popc(m);\n"),
            ("      if (__any_sync(kFull, mn[r] < wq.kth[r]))\n"
             "        fold_row_chunk_wide(",
             "      if (__any_sync(kFull, mn[r] < wq.kth[r])) {\n"
             "        const long long pr0 = clock64();\n"
             "        fold_row_chunk_wide("),
            (_ROW_CALL_END, _ROW_CALL_END
             + "        probe_add(2, clock64() - pr0);\n      }\n"),
            ("    if (pend.n[r]) {\n      wq.kth[r] = wide_merge(",
             "    if (pend.n[r]) {\n      const long long pf0 = clock64();\n"
             "      wq.kth[r] = wide_merge("),
            ("      pend.n[r] = 0;\n    }\n",
             "      pend.n[r] = 0;\n      probe_add(5, clock64() - pf0);\n"
             "      probe_add(7, 1);\n    }\n"),
        ],
        "knn_tiled.cu": [
            ("  knn::wide_kth(wd2, k, valid, wq);\n",
             "  knn::wide_kth(wd2, k, valid, wq);\n  knn::probe_begin();\n"
             "  const long long pk0 = clock64();\n"
             "  for (int r = 0; r < kWarpRows; ++r)\n"
             "    knn::probe_add(9, valid[r]);\n"),
            ("    knn::fold_tile_wide(",
             "    const long long ptl = clock64();\n    knn::fold_tile_wide("),
            ("                        wd2, widx, k);\n",
             "                        wd2, widx, k);\n"
             "    knn::probe_add(1, clock64() - ptl);\n"
             "    knn::probe_add(10, 1);\n"
             "    if (c == 0) knn::probe_add(11, 1);\n"),
            ("(n >> 1) & 1);\n"
             "  if (tid == 0 && nvis) atomicMax(visits + b, nvis);\n",
             "(n >> 1) & 1);\n  knn::probe_add(0, clock64() - pk0);\n"
             "  knn::probe_end();\n"
             "  if (tid == 0 && nvis) atomicMax(visits + b, nvis);\n"),
        ],
        "knn_bf.cu": [
            ("  knn::wide_kth(wd2, k, valid, wq);\n",
             "  knn::wide_kth(wd2, k, valid, wq);\n  knn::probe_begin();\n"
             "  const long long pk0 = clock64();\n"
             "  for (int r = 0; r < kWarpRows; ++r)\n"
             "    knn::probe_add(9, valid[r]);\n"),
            ("    knn::fold_tile_wide(",
             "    const long long ptl = clock64();\n    knn::fold_tile_wide("),
            ("                        wd2, widx, k);\n",
             "                        wd2, widx, k);\n"
             "    knn::probe_add(1, clock64() - ptl);\n"
             "    knn::probe_add(10, 1);\n"),
            ("  knn::wide_flush(wq, pend, wd2, widx, k);\n}\n",
             "  knn::wide_flush(wq, pend, wd2, widx, k);\n"
             "  knn::probe_add(0, clock64() - pk0);\n"
             "  knn::probe_end();\n}\n"),
        ],
    },
    # the wide fold of shared-memory buffers (kWideBuffer entries a row),
    # sorted once a merge (wide_sort), flushed lazily by the traversal
    "buffered": {
        "knn_rows.cuh": [
            ("namespace knn {\n", _PROBE),
            ("  wide_sort(keys, pd2, n);\n",
             "  const long long pt0 = clock64();\n"
             "  wide_sort(keys, pd2, n);\n"
             "  const long long pt1 = clock64();\n"
             "  probe_add(3, pt1 - pt0);\n"),
            ("  if (tail) wide_keep_tail(rd2, k, tail);\n"
             "  return rd2[k - 1];\n",
             "  probe_add(4, clock64() - pt1);\n  probe_add(6, 1);\n"
             "  if (tail) wide_keep_tail(rd2, k, tail);\n"
             "  return rd2[k - 1];\n"),
            ("    pn += __popc(m);\n",
             "    probe_add(8, __popc(m));\n    pn += __popc(m);\n"),
            ("      if (groups)\n        fold_row_chunk_wide<kSteps>(",
             "      if (groups) {\n"
             "        const long long pr0 = clock64();\n"
             "        fold_row_chunk_wide<kSteps>("),
            ("pn[r], ww.key, wide_tail(ww, r));\n",
             "pn[r], ww.key, wide_tail(ww, r));\n"
             "        probe_add(2, clock64() - pr0);\n      }\n"),
            ("    if (pn[r]) {\n      wq.kth[r] = wide_merge<kSteps>(",
             "    if (pn[r]) {\n      const long long pf0 = clock64();\n"
             "      wq.kth[r] = wide_merge<kSteps>("),
            ("      pn[r] = 0;\n    }\n",
             "      pn[r] = 0;\n      probe_add(5, clock64() - pf0);\n"
             "      probe_add(7, 1);\n    }\n"),
        ],
        "knn_tiled.cu": [
            ("  knn::wide_kth(wd2, k, valid, wq);\n",
             "  knn::wide_kth(wd2, k, valid, wq);\n  knn::probe_begin();\n"
             "  const long long pk0 = clock64();\n"
             "  for (int r = 0; r < kWarpRows; ++r)\n"
             "    knn::probe_add(9, valid[r]);\n"),
            ("    if (c == 0) {\n      // ascending box d2",
             "    const long long pw0 = clock64();\n"
             "    if (c == 0) {\n      // ascending box d2"),
            ("      if (verdict < 0) break;\n    }\n",
             "      if (verdict < 0) break;\n    }\n"
             "    knn::probe_add(13, clock64() - pw0);\n"),

            ("    knn::fold_tile_wide<kSteps>(",
             "    const long long ptl = clock64();\n"
             "    knn::fold_tile_wide<kSteps>("),
            ("t_pad - c * tile_lanes), wq, pn, wd2, widx, k, ww);\n",
             "t_pad - c * tile_lanes), wq, pn, wd2, widx, k, ww);\n"
             "    knn::probe_add(1, clock64() - ptl);\n"
             "    knn::probe_add(10, 1);\n"
             "    if (c == 0) knn::probe_add(11, 1);\n"),
            ("        knn::wide_flush<kSteps>(wq, pn, wd2, widx, k, ww);\n"
             "        ++f;\n",
             "        knn::probe_add(12, 1);\n"
             "        knn::wide_flush<kSteps>(wq, pn, wd2, widx, k, ww);\n"
             "        ++f;\n"),
            ("  knn::wide_flush<kSteps>(wq, pn, wd2, widx, k, ww);\n"
             "  if (tid == 0 && q)",
             "  knn::wide_flush<kSteps>(wq, pn, wd2, widx, k, ww);\n"
             "  knn::probe_add(0, clock64() - pk0);\n  knn::probe_end();\n"
             "  if (tid == 0 && q)"),
        ],
        "knn_bf.cu": [
            ("  knn::wide_kth(wd2, k, valid, wq);\n",
             "  knn::wide_kth(wd2, k, valid, wq);\n  knn::probe_begin();\n"
             "  const long long pk0 = clock64();\n"
             "  for (int r = 0; r < kWarpRows; ++r)\n"
             "    knn::probe_add(9, valid[r]);\n"),
            ("    knn::mbar_wait(full + s, (t / kWideStages) & 1);\n",
             "    const long long pw0 = clock64();\n"
             "    knn::mbar_wait(full + s, (t / kWideStages) & 1);\n"
             "    knn::probe_add(13, clock64() - pw0);\n"),
            ("    knn::fold_tile_wide<kSteps>(",
             "    const long long ptl = clock64();\n"
             "    knn::fold_tile_wide<kSteps>("),
            ("        pn, wd2, widx, k, ww);\n",
             "        pn, wd2, widx, k, ww);\n"
             "    knn::probe_add(1, clock64() - ptl);\n"
             "    knn::probe_add(10, 1);\n"),
            ("  knn::wide_flush<kSteps>(wq, pn, wd2, widx, k, ww);\n}\n",
             "  knn::wide_flush<kSteps>(wq, pn, wd2, widx, k, ww);\n"
             "  knn::probe_add(0, clock64() - pk0);\n"
             "  knn::probe_end();\n}\n"),
        ],
    },
}


def design_of(csrc: Path) -> str:
    """Which design of the wide fold ``csrc`` holds."""
    text = (csrc / "knn_rows.cuh").read_text()
    if "warp_sort(d, key, id);" in text:
        return "registers"
    return "buffered"


def edited(csrc: Path, design: str | None, name: str) -> str:
    """``csrc/name`` with the design's probe edits (none for ``None``)."""
    text = (csrc / name).read_text()
    for old, new in (EDITS[design].get(name, []) if design else []):
        if text.count(old) != 1:
            raise SystemExit(f"{design} {name}: {text.count(old)} matches "
                             f"of {old.strip()[:60]!r}")
        text = text.replace(old, new)
    return text


def build(root: Path, design: str, out_dir: Path):
    """Compile both kernels twice from the checkout's sources: unedited
    and with the design's probe edits (four nvcc at once). Returns
    ({name: library}, {name: instrumented library})."""
    from mpi_cuda_largescaleknn_torch.utils.cuda_build import (
        NVCC_FLAGS,
        _nvcc,
    )

    csrc = root / "mpi_cuda_largescaleknn_torch" / "csrc"
    procs = {}
    for kind, edits in (("base", None), ("probe", design)):
        where = out_dir / kind
        where.mkdir(parents=True, exist_ok=True)
        for name in csrc.glob("*.cuh"):
            (where / name.name).write_text(edited(csrc, edits, name.name))
        for name in ("knn_tiled", "knn_bf"):
            src = where / f"{name}.cu"
            src.write_text(edited(csrc, edits, f"{name}.cu")
                           + (_READERS if edits else ""))
            lib = where / f"{name}.so"
            procs[kind, name] = (lib, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-I", str(where), "-o", str(lib),
                 str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    libs = {"base": {}, "probe": {}}
    for (kind, name), (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {kind} {name}:\n{out}")
        libs[kind][name] = typed(ctypes.CDLL(str(path)))
    return libs["base"], libs["probe"]


def typed(lib):
    """Sets the launchers' ctypes signatures on ``lib``."""
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import _SIGNATURES

    sig = _SIGNATURES["knn_tiled"]["knn_tiled_launch"]
    fn = getattr(lib, "knn_tiled_launch", None)
    if fn is not None:
        fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                       for c in sig]
        fn.restype = ctypes.c_int
    fn = getattr(lib, "knn_bf_launch", None)
    if fn is not None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def traversal_case(label, q, p, start, skip_self, group):
    """A traversal launch's operands (the D=3 plan of the tree)."""
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        CHUNK_LANES,
        d3_lanes,
        d3_slots,
        tiled_launch_plan,
    )
    from mpi_cuda_largescaleknn_torch.ops.partition import (
        nearest_first_order,
    )
    from mpi_cuda_largescaleknn_torch.utils.math import round_up

    sorted_d2, order = nearest_first_order(q.lower, q.upper, p.lower,
                                           p.upper)
    num_pb, t_p = p.ids.shape
    t_pad = round_up(t_p, CHUNK_LANES)
    k = start.dist2.shape[1]
    plan = tiled_launch_plan(q.ids.shape[1], t_p, k, 3)
    return {"label": label, "kind": "traversal", "q": q, "p": p,
            "start": start, "order": order.contiguous(),
            "sorted_d2": sorted_d2.contiguous(),
            "p4": d3_lanes(p.pts, p.ids, t_pad), "t_pad": t_pad,
            "skip_self": int(skip_self), "group": group, "plan": plan,
            "slots": d3_slots(k), "rows": q.ids.numel()}


def flat_case(label, pts, k, query_tile=2048):
    """The flat fold's operands, n x n cold, its blocks planned for
    ``query_tile`` rows."""
    import torch

    from mpi_cuda_largescaleknn_torch.ops.candidates import init_candidates
    from mpi_cuda_largescaleknn_torch.ops.knn_bf import flat_d3_plan
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        CHUNK_LANES,
        d3_lanes,
        d3_slots,
    )
    from mpi_cuda_largescaleknn_torch.utils.math import round_up

    n = pts.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=pts.device)
    np_pad = round_up(n, CHUNK_LANES)
    return {"label": label, "kind": "flat", "q": pts.contiguous(),
            "start": init_candidates(n, k, device=pts.device),
            "p4": d3_lanes(pts, ids, np_pad), "np_pad": np_pad,
            "plan": flat_d3_plan(query_tile, 2048, k), "slots": d3_slots(k),
            "rows": n}


def launch(lib, case):
    """One launch of ``case`` on ``lib``; returns (ms by CUDA events, the
    rows it left)."""
    import torch

    from mpi_cuda_largescaleknn_torch.core.types import CandidateState
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        MAX_GRID_Y,
        WARP_ROWS,
        grid_y_pieces,
    )

    rows = CandidateState(case["start"].dist2.clone(),
                          case["start"].idx.clone())
    plan = case["plan"]
    k = rows.dist2.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    marks[0].record()
    if case["kind"] == "flat":
        err = lib.knn_bf_launch(
            case["q"].data_ptr(), case["p4"].data_ptr(),
            rows.dist2.data_ptr(), rows.idx.data_ptr(), case["q"].shape[0],
            case["np_pad"], k, case["slots"], plan.threads, plan.lanes,
            plan.smem, stream)
    else:
        q, p = case["q"], case["p"]
        num_qb, s_q = q.ids.shape
        visits = torch.zeros(num_qb, dtype=torch.int32, device=q.ids.device)
        q_pts, q_ids = q.pts.contiguous(), q.ids.contiguous()
        blocks = -(-s_q // (plan.threads // 32 * WARP_ROWS))
        for y0, ny in grid_y_pieces(blocks, MAX_GRID_Y):
            err = lib.knn_tiled_launch(
                case["order"].data_ptr(), case["sorted_d2"].data_ptr(),
                q_pts.data_ptr(), q_ids.data_ptr(), case["p4"].data_ptr(),
                rows.dist2.data_ptr(), rows.idx.data_ptr(),
                visits.data_ptr(), num_qb, s_q, p.ids.shape[0],
                case["t_pad"], k, case["skip_self"], case["group"],
                case["slots"], 0, plan.threads, plan.lanes, plan.smem, y0,
                ny, stream)
            if err:
                break
    marks[1].record()
    torch.cuda.synchronize()
    if err:
        raise SystemExit(f"{case['label']}: launch failed, CUDA error {err}")
    return marks[0].elapsed_time(marks[1]), rows


def split(counts, rows) -> dict:
    """Shares of the warps' cycles by section, and counts a row."""
    c = dict(zip(NAMES, counts))
    rows = c["rows"] or rows
    total = max(c["total"], 1)
    overflow = c["sort"] + c["walk"] - c["flush"]
    out = {
        "gate_and_scoring": (c["tile"] - c["row_fold"]) / total,
        "rescoring_and_compaction": (c["row_fold"] - overflow) / total,
        "overflow_merges": overflow / total,
        "flushes": c["flush"] / total,
        "sort_in_all_merges": c["sort"] / total,
        "walk_in_all_merges": c["walk"] / total,
        "barriers_copies_and_rest": (total - c["tile"] - c["flush"]) / total,
        "merges_a_row": (c["merges"] - c["flush_merges"]) / rows,
        "flushes_a_row": c["flush_merges"] / rows,
        "buffered_a_row": c["buffered"] / rows,
        "tiles_a_warp": c["tiles"] / max(rows / 4, 1),
    }
    if c["waits"] or c["publish"]:
        # the flat fold's waits for its tiles; the traversal's decisions
        out["waits"] = c["waits"] / total
        out["publishing_bounds"] = c["publish"] / total
    if c["decisions"]:
        out["bucket_starts"] = c["decisions"]
        out["lazy_flush_decisions"] = c["lazy_flushes"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--shapes", default="device_merge,traversal,flat")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as smoke
    from mpi_cuda_largescaleknn_torch.ops.candidates import init_candidates
    from mpi_cuda_largescaleknn_torch.ops.partition import (
        coarsen_buckets,
        partition_points,
    )
    from mpi_cuda_largescaleknn_torch.ops.tiled import warm_start_self
    from mpi_cuda_largescaleknn_torch.parallel.ring import chunk_bucket

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this probe times a CUDA kernel")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    csrc = root / "mpi_cuda_largescaleknn_torch" / "csrc"
    design = design_of(csrc)
    print(f"{smi}; {root}: the {design} wide fold", flush=True)
    t0 = time.perf_counter()
    bases, probes = build(root, design, root / "build" / "probe_d3_wide")
    for lib in probes.values():
        lib.knn_probe_reset.restype = ctypes.c_int
        lib.knn_probe_read.argtypes = [ctypes.c_void_p]
        lib.knn_probe_read.restype = ctypes.c_int
    print(f"  built in {time.perf_counter() - t0:.1f} s", flush=True)
    k = smoke.LARGE_K
    pts_np = smoke.seeded_points("uniform", smoke.N_MAIN, smoke.SEED + 2)
    pts = torch.from_numpy(pts_np).cuda()
    res = {"device": smi, "design": design, "root": str(root), "k": k,
           "shapes": {}}
    for shape in args.shapes.split(","):
        if shape == "device_merge":
            _f, resident, group, _last, chunk = smoke.chunk_sides(
                pts_np, 4, k, smoke.LARGE_CHUNK)
            _lo, _hi, qp, _qi = chunk(0)
            rows_t = qp.reshape(-1, 3)
            qb = chunk_bucket(rows_t)
            cold = init_candidates(rows_t.shape[0], k, device=pts.device)
            case = traversal_case(shape, qb, resident[0], cold, False, group)
            del resident
        elif shape == "traversal":
            q = partition_points(pts, bucket_size=256)
            pc = coarsen_buckets(q, 2)
            case = traversal_case(shape, q, pc, warm_start_self(pc, k), True,
                                  2)
        elif shape == "flat":
            case = flat_case(shape, pts, k)
        else:
            raise SystemExit(f"unknown shape {shape!r}")
        lib_name = "knn_bf" if case["kind"] == "flat" else "knn_tiled"
        base, probe = bases[lib_name], probes[lib_name]
        launch(base, case)  # loads the module
        base_ms, want = [], None
        probe_ms, counts = [], None
        for _ in range(args.reps):
            ms, want = launch(base, case)
            base_ms.append(ms)
            probe.knn_probe_reset()
            ms, got = launch(probe, case)
            probe_ms.append(ms)
            buf = (ctypes.c_ulonglong * SLOTS)()
            probe.knn_probe_read(buf)
            counts = list(buf)
            if not (torch.equal(got.dist2, want.dist2)
                    and torch.equal(got.idx, want.idx)):
                raise SystemExit(f"{shape}: the probe's rows differ")
        rec = {"plan": case["plan"]._asdict(), "rows": case["rows"],
               "ms": base_ms, "probe_ms": probe_ms,
               "counters": dict(zip(NAMES, counts)),
               "split": split(counts, case["rows"])}
        res["shapes"][shape] = rec
        print(f"{shape}: {case['rows']} rows, kernel "
              + " / ".join(f"{t:.3f}" for t in base_ms) + " ms, probed "
              + " / ".join(f"{t:.3f}" for t in probe_ms) + " ms", flush=True)
        print("  " + json.dumps(rec["split"]), flush=True)
        del case, want
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
