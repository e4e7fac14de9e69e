"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``) and
the parameters of both that are its own. ``BENCHMARK.json`` says which
end-to-end and per-layer metrics the cell reports; a per-layer metric is
read by ``metrics/<metric>.py``. Adding a cell, a configuration, a mix, a
metric or a driver adds files and entries and edits none.

A cell is driven by one of the built-in drivers of ``drivers.py`` (``jobs``,
``ring``, ``open``, chosen by its mix and its ranks), or by the driver file
its configuration names with ``"pipeline": "<name>"``:
``pipelines/<name>.py`` in the checkout that describes the cell. That file
defines

- ``READS = (config_keys, mix_keys)``: the keys it reads, as ``READS``
  below gives them for the built-in drivers;
- ``run(cell, seed, seconds, trace, device, t_start) -> drivers.Run``, as
  ``drivers.run_jobs``;
- optionally ``check(name, config, traffic)``, which raises ValueError
  where the sizes disagree.

A configuration with ``"pipeline": "x"`` and a ``pipelines/x.py`` is all
that a cell driven by ``x`` needs; no other file here changes.

Every key of a cell's files is either read by the driver that runs it
(``READS``, or the pipeline file's) or only describes the file
(``ABOUT``); ``load_cell`` refuses any other, so that no file states a
setting the run leaves unread.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent

#: keys that describe a file to its reader and drive nothing
ABOUT = frozenset({"name", "source", "deployment", "guarantees",
                   "source_values", "reduced", "assumed", "about"})
_SIZES = {"points", "points_per_rank", "ranks", "points_total", "k",
          "score_dtype", "engine", "control_precision"}
#: the configuration keys and the mix keys that each driver (and, for
#: ``control_precision``, control.py) reads
READS = {
    # UnorderedKNN(KnnConfig(...)).run: the chunked route's keys too
    "jobs": (_SIZES | {"query_chunk", "merge"}, {"loop", "sample_per_job"}),
    # ring_knn(..., mesh=) in each of ``ranks`` processes
    "ring": (_SIZES, {"loop", "sample_per_job"}),
    # serve_main's server and loadgen.py's open loop
    "open": (_SIZES, {"loop", "arrivals", "rate_per_s", "rows", "queries",
                      "workers", "sample_requests"}),
}
#: the keys of each point distribution (data.py) and request size (arrivals.py)
POINT_KEYS = {"uniform": {"kind", "dim"},
              "clustered": {"kind", "dim", "clusters", "center_sigma",
                            "sigma"}}
ROW_KEYS = {"log_uniform": {"dist", "max"}, "fixed": {"dist", "rows"}}
CELL_KEYS = {"config", "traffic", "chips", "why", "check", "config_params",
             "traffic_params"}


@dataclass
class Cell:
    name: str
    root: Path          # the checkout that describes the cell
    chips: int
    config: dict        # configs/<config>.json, with the cell's overrides
    traffic: dict       # traffic/<mix>.json, with the cell's overrides
    end_to_end: list    # BENCHMARK.json end_to_end entries for this cell
    per_layer: list     # BENCHMARK.json per_layer entries for this cell
    check: dict         # the limit of each number the check compares


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    names = metric.get("workloads")
    return names is None or cell in names


def driver_of(config: dict, traffic: dict) -> str:
    """The driver of a cell: the configuration's ``pipeline``, else
    ``"jobs"``, ``"ring"`` or ``"open"``."""
    if "pipeline" in config:
        return config["pipeline"]
    loop = traffic.get("loop")
    if loop == "open":
        return "open"
    if loop == "jobs":
        return "ring" if int(config.get("ranks", 1)) > 1 else "jobs"
    raise ValueError(f"unknown traffic loop {loop!r}")


def _refuse_unread(where: str, keys, reads) -> None:
    unread = sorted(set(keys) - set(reads) - ABOUT)
    if unread:
        raise ValueError(f"{where}: no driver reads {', '.join(unread)}")


def pipeline(name: str, root: Path | None = None):
    """The module ``pipelines/<name>.py`` of the checkout ``root``. Raises
    ValueError for a built-in driver's name, a name with no file, or a file
    without ``READS`` and ``run``."""
    if name in READS:
        raise ValueError(f"pipeline {name!r} is a built-in driver's name")
    here = HERE if root is None else Path(root) / "knnbench"
    path = here / "pipelines" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"pipeline {name!r}: no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"knnbench_pipeline_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    lacks = [attr for attr in ("READS", "run") if not hasattr(module, attr)]
    if lacks:
        raise ValueError(f"pipelines/{name}.py defines no "
                         f"{' and no '.join(lacks)}")
    return module


def check_keys(name: str, own: dict, config: dict, traffic: dict,
               root: Path | None = None) -> None:
    """Raise ValueError for a key of the cell's files that its driver does
    not read, or sizes that disagree. A pipeline file is looked for in the
    checkout ``root``."""
    driver = driver_of(config, traffic)
    module = pipeline(driver, root) if "pipeline" in config else None
    if module is None:
        config_reads, mix_reads = READS[driver]
    else:
        config_reads, mix_reads = module.READS
        config_reads = {*config_reads, "pipeline"}
    _refuse_unread(f"workloads/{name}.json", own, CELL_KEYS)
    _refuse_unread(f"{name}'s configuration", config, config_reads)
    _refuse_unread(f"{name}'s mix", traffic, mix_reads)
    points = config["points"]
    _refuse_unread(f"{name}'s points", points,
                   POINT_KEYS.get(points["kind"], ()))
    if "rows" in traffic:
        _refuse_unread(f"{name}'s request rows", traffic["rows"],
                       ROW_KEYS.get(traffic["rows"]["dist"], ()))
    ranks = int(config.get("ranks", 1))
    if module is None and driver != "ring" and ranks != 1:
        raise ValueError(f"{name}: the {driver} driver runs one rank, the "
                         f"configuration has {ranks}")
    total = config.get("points_total")
    if (total is not None
            and int(total) != int(config["points_per_rank"]) * ranks):
        raise ValueError(f"{name}: points_total {total} is not "
                         f"points_per_rank x ranks")
    check = getattr(module, "check", None)
    if check is not None:
        check(name, config, traffic)


def load_cell(name: str, root: Path | None = None,
              bench: dict | None = None) -> Cell:
    """The cell ``name`` as ``BENCHMARK.json`` (in ``root``, the checkout)
    and its files describe it. Raises KeyError for a cell
    ``BENCHMARK.json`` does not list, and ValueError for files that
    disagree with it, state a key no driver reads, or name a pipeline
    with no sound file."""
    here = HERE if root is None else Path(root) / "knnbench"
    if bench is None:
        bench = _read_json(here.parent / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    own = _read_json(here / "workloads" / f"{name}.json")
    if (own["config"], own["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json names {own['config']} / "
                         f"{own['traffic']}, BENCHMARK.json "
                         f"{entry['config']} / {entry['traffic']}")
    config = _read_json(here / "configs" / f"{entry['config']}.json")
    config.update(own.get("config_params", {}))
    traffic = _read_json(here / "traffic" / f"{entry['traffic']}.json")
    traffic.update(own.get("traffic_params", {}))
    check_keys(name, own, config, traffic, here.parent)
    return Cell(name=name, root=here.parent, chips=int(entry["chips"]),
                config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)],
                check=dict(own["check"]))


def metric_reader(name: str, root: Path | None = None):
    """``read(record) -> float | None`` of ``metrics/<name>.py``."""
    here = HERE if root is None else Path(root) / "knnbench"
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"knnbench_metric_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
