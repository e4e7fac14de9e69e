"""Which program phase launched each device op of a self-join job, and
where the job's time goes, from the port's ``lsk.*`` spans.

Runs a one-rank benchmark cell's jobs as ``knnbench/drivers.py`` runs them
(``UnorderedKNN(KnnConfig(...)).run`` on host points drawn from the seed),
or as the cell's pipeline file does where its configuration names one
(``model(cfg, device)``, ``host_parts(cfg, device, seed, ...)`` and the
phases ``JOB_PHASES`` of ``knnbench/pipelines/<name>.py``, such as the
pre-partitioned job's ``PrePartitionedKNN.run`` on its partitions):
one warm-up job, then ``--jobs`` jobs untraced and the same jobs again
under ``torch.profiler``, each traced job marked as
``knnbench/devtrace.py`` marks a window. Prints one JSON object, and
writes it to ``--out``:

- ``points_per_s``: untraced and traced (the profiler's cost);
- ``job_s``, ``stages``: a traced job's wall time and each ``PhaseTimers``
  phase's seconds a job; ``covered``: the host phases (``shard_and_pad``,
  ``download``, ``trim``) and the ring's stages (``upload``,
  ``partition``, ``warm_start``, ``traverse``, ``extract``), or the
  pipeline's ``JOB_PHASES``, over the job's time;
- ``device_ops``: the device ops with the most time, each split by the
  path of ``lsk.*`` spans around the host call that launched it;
- ``idle_gaps``, ``idle_lsk_share``: ``devtrace.summarize``'s labels of
  the card's idle gaps, and the share of their seconds that ``lsk.*``
  spans carry.

    python3 tools/torch_span_breakdown.py --workload selfjoin-3d-k100 \\
        --seed 5 [--jobs 3] [--points N] [--device cuda|cpu] [--out F.json]

``--points`` shrinks the cell (a rehearsal on the CPU); the card's name
and power limit go beside the numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: the phases a self-join job's time is made of (``covered``)
JOB_PHASES = ("shard_and_pad", "upload", "partition", "warm_start",
              "traverse", "extract", "download", "trim")


def span_path(event) -> str:
    """The ``lsk.*`` spans around a profiler event, outermost first."""
    names = []
    while event is not None:
        if event.name.startswith("lsk."):
            names.append(event.name)
        event = event.cpu_parent
    return "/".join(reversed(names)) or "(no span)"


def _innermost(spans: list, t: float):
    """The latest-starting span (by start) that holds ``t``: spans nest."""
    for e in reversed(spans):
        if e.time_range.start <= t <= e.time_range.end:
            return e
    return None


def device_by_span(events, window: str) -> dict[str, dict[str, float]]:
    """{device op: {span path: seconds}} of the kernels and copies launched
    inside the spans named ``window``: each under the ``lsk.*`` spans
    around the host call that launched it (the CUDA runtime call with its
    correlation id), so kernels launched outside any torch operator (the
    port's ctypes launchers) are placed too; "(unmatched)" where the trace
    holds no launch."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type != DeviceType.CUDA]
    spans = sorted((e for e in host if e.name.startswith("lsk.")),
                   key=lambda e: e.time_range.start)
    wins = [e.time_range for e in host if e.name == window]
    launches = {e.id: e.time_range.start for e in host
                if e.name.startswith("cu")}
    out: dict[str, dict[str, float]] = {}
    for e in events:
        if (e.device_type != DeviceType.CUDA or e.name == window
                or getattr(e, "is_user_annotation", False)):
            continue
        t = launches.get(e.id)
        if t is None:
            path = "(unmatched)"
        elif not any(w.start <= t <= w.end for w in wins):
            continue
        else:
            inner = _innermost(spans, t)
            path = span_path(inner) if inner is not None else "(no span)"
        by_path = out.setdefault(e.name, {})
        by_path[path] = (by_path.get(path, 0.0)
                         + (e.time_range.end - e.time_range.start) / 1e6)
    return out


def top_ops(by_span: dict, top: int, per_job: int) -> list[dict]:
    ops = sorted(by_span.items(), key=lambda kv: -sum(kv[1].values()))
    return [{"op": name, "s_per_job": sum(paths.values()) / per_job,
             "spans": {p: s / per_job for p, s in sorted(
                 paths.items(), key=lambda kv: -kv[1])}}
            for name, paths in ops[:top]]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "cpu"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--jobs", type=int, default=3)
    p.add_argument("--points", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from knnbench import data, devtrace
    from knnbench.spec import load_cell, pipeline
    from mpi_cuda_largescaleknn_torch.core.config import KnnConfig
    from mpi_cuda_largescaleknn_torch.models.unordered import UnorderedKNN

    cell = load_cell(args.workload)
    cfg, spec = cell.config, cell.config["points"]
    device = torch.device(args.device)
    phases = JOB_PHASES
    if "pipeline" in cfg:
        piped = pipeline(cfg["pipeline"], cell.root)
        ranks = int(cfg["ranks"])
        if args.points:
            npr = args.points // ranks
            cfg = dict(cfg, points_per_rank=npr, points_total=npr * ranks)
        n = int(cfg["points_per_rank"]) * ranks
        model = piped.model(cfg, device)
        phases = piped.JOB_PHASES

        def points(*parts):
            return piped.host_parts(cfg, device, args.seed, *parts)
    else:
        n = args.points or int(cfg["points_per_rank"])
        model = UnorderedKNN(KnnConfig(
            k=int(cfg["k"]), device=str(device),
            **{key: cfg[key] for key in ("engine", "score_dtype",
                                         "query_chunk", "merge")
               if key in cfg}))

        def points(*parts):
            return data.host_points(spec, n, device, args.seed, *parts)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def jobs(window) -> float:
        wall = 0.0
        for j in range(args.jobs):
            pts = points("job", j)
            with window():
                t0 = time.perf_counter()
                model.run(pts)
                wall += time.perf_counter() - t0
        return wall

    model.run(points("warmup", 0))
    sync()
    plain_s = jobs(contextlib.nullcontext)
    before = {k: r.seconds for k, r in model.timers.phases.items()}
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        traced_s = jobs(lambda: record_function(devtrace.WINDOW))
    stages = {k: (r.seconds - before.get(k, 0.0)) / args.jobs
              for k, r in model.timers.phases.items()}
    job_s = traced_s / args.jobs
    summary = devtrace.summarize(prof)
    gaps = summary["idle_gaps"] if summary else []
    labelled = sum(s for _, s in gaps)
    out = {
        "workload": args.workload, "seed": args.seed, "points": n,
        "jobs": args.jobs, "card": card(),
        "points_per_s": {"untraced": n * args.jobs / plain_s,
                         "traced": n * args.jobs / traced_s},
        "job_s": job_s, "stages": stages,
        "covered": sum(stages.get(k, 0.0) for k in phases) / job_s,
        "device_ops": top_ops(device_by_span(prof.events(), devtrace.WINDOW),
                              8, args.jobs),
        "idle_gaps": [[label, s / args.jobs] for label, s in gaps[:10]],
        "idle_lsk_share": (sum(s for label, s in gaps
                               if label.startswith("lsk.")) / labelled
                           if labelled else None),
        "busy_share": (summary["busy_s"] / summary["window_s"]
                       if summary else None),
    }
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
