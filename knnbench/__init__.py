"""The benchmark of the PyTorch and CUDA port (``mpi_cuda_largescaleknn_torch``).

One command runs one cell once, from the root of a checkout:

    python3 -m knnbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root names the cells, configurations, traffic mixes
and metrics. Each of them is a file of its own here, found by its name:

- ``configs/<config>.json``: the deployment's sizes, its guarantees and
  the port's options it runs with (``engine``, ``score_dtype``, ...);
- ``traffic/<mix>.json``: the parameters of one traffic mix, read by
  ``arrivals.py`` (open loop) or by the job loop of ``drivers.py``;
- ``workloads/<cell>.json``: the cell's configuration, mix and parameters;
- ``metrics/<metric>.py``: one per-layer metric's reader over the traced
  run's record;
- ``pipelines/<name>.py``: the driver of a cell whose configuration says
  ``"pipeline": "<name>"`` (``spec.pipeline``); the other cells take one
  of ``drivers.py``'s three.

Every key of those files is read by the cell's driver or only describes
the file; ``spec.load_cell`` refuses any other.

Nothing here imports ``jax`` or the JAX package, and ``reference.py``,
``roofline.py``, ``arrivals.py``, ``loadgen.py`` and ``devtrace.py`` import
nothing of the port.
"""
