"""One further rank of a ring cell (``drivers.run_ring`` starts them).

    python3 -m knnbench.rank '<json: workload, seed, seconds, trace, rank,
                               world, port, device_type>'

Prints its rank's result as one JSON line on stdout; exits 3, printing
none, if ``jax``, ``jaxlib``, ``flax`` or the JAX package has been imported
by the end of its run, as ``run.py`` does for rank 0.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402


def main() -> int:
    args = json.loads(sys.argv[1])
    from knnbench.drivers import ring_rank
    from knnbench.run import forbidden_modules
    from knnbench.spec import load_cell

    out = ring_rank(load_cell(args["workload"], args["root"]), args["seed"],
                    args["seconds"], args["trace"], args["rank"],
                    args["world"], args["port"], args["device_type"],
                    T_START)
    found = forbidden_modules()
    if found:
        sys.stderr.write(f"knnbench: rank {args['rank']} imported "
                         f"{', '.join(found)}\n")
        return 3
    sys.stdout.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
