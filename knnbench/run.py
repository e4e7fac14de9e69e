"""Run one cell of the port's benchmark once and print its result.

    python3 -m knnbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, kernels built or loaded, the cell's data, one warm-up of
every shape the window uses) is timed from this module's first line to the
window's start. The window runs for ``--seconds``; with ``--trace 1`` it is
profiled, and the per-layer metrics replace the end-to-end ones. After the
window the port's state is freed and the plain reference checks the
answers. The last lines on stderr, and the ``checks`` key that comes last
in the result, give each number compared beside its limit. The last line
on stdout is the result's JSON.

Exits 2, printing no result, without as many CUDA cards as the cell asks
for; exits 3 if ``jax``, ``jaxlib``, ``flax`` or the JAX package has been
imported by the end of the run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the port builds its kernels into the checkout's build/ (utils/cuda_build.py);
# torch's own build and kernel caches go to fixed paths beside them, so only
# a checkout's first run builds
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = str(ROOT / "build" / "knnbench" / _sub)

#: top-level modules the run may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "mpi_cuda_largescaleknn_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def result_line(cell, run, trace: bool, root=None) -> dict:
    """The result's JSON: the cell's end-to-end metrics (``trace`` off) or
    the per-layer metrics its readers find (``trace`` on)."""
    from knnbench.spec import metric_reader

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = metric_reader(m["name"], root)(run.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": run.metrics[m["name"]],
                                  "unit": m["unit"]}
    device = dict(run.device)
    out = {"correct": all(v <= lim for v, lim in run.checks.values()),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    summary = run.record.get("trace")
    if trace and summary:
        from knnbench import devtrace

        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        out["breakdown"] = devtrace.breakdown(summary)
    for key in ("setup_parts", "latency_ms", "retried"):
        if key in run.record:
            out[key] = run.record[key]
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, (v, lim) in run.checks.items()}
    return out


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, root=None) -> dict:
    """Drive the cell on ``device`` and return the result's dict. ``root``
    is the checkout whose ``BENCHMARK.json`` and ``knnbench/`` files
    describe the cell (default: this one). The tests call this on the
    CPU; ``main`` insists on the cards."""
    from knnbench.drivers import drive
    from knnbench.spec import load_cell

    cell = load_cell(workload, root)
    run = drive(cell, seed, seconds, trace, device, t_start)
    return result_line(cell, run, trace, root)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from knnbench.spec import load_cell

    chips = load_cell(args.workload).chips
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        sys.stderr.write(f"knnbench: {args.workload} needs {chips} CUDA "
                         f"card(s), this machine has {have}\n")
        return 2
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        sys.stderr.write(f"knnbench: the run imported {', '.join(found)}\n")
        return 3
    for name, c in out["checks"].items():
        sys.stderr.write(f"check {name}: {c['value']!r} (limit "
                         f"{c['limit']!r})\n")
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
