"""``torchknn-partition`` — the spatial pre-partitioner that feeds
``prepartitioned_main``:

    python -m mpi_cuda_largescaleknn_torch.cli.partition_main points.float3 \
        -n 8 -o parts/run [--bits B]

writes ``parts/run_%06d.float3`` (near-equal sizes, Morton-coherent) and
``parts/run.txt`` (the file list). Out of core: the native library
streams the file in three passes in O(8^B) memory (~40 MB at the default
B = 7), whatever its size; numpy, in memory, only where there is no
``g++``. No card needed.
"""

from __future__ import annotations

import sys

from mpi_cuda_largescaleknn_torch.io.partition_file import (
    partition_float3_file,
)


def usage(err: str) -> "NoReturn":  # noqa: F821
    sys.stderr.write(f"Error: {err}\n\n"
                     "torchknn-partition <input.float3> -n <numParts> "
                     "-o <outPrefix> [--bits B]\n")
    sys.exit(1)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    in_path, out_prefix, num_parts, bits = "", "", 0, 7
    i = 0
    try:
        while i < len(argv):
            a = argv[i]
            if a == "-o":
                i += 1; out_prefix = argv[i]
            elif a == "-n":
                i += 1; num_parts = int(argv[i])
            elif a == "--bits":
                i += 1; bits = int(argv[i])
            elif not a.startswith("-"):
                in_path = a
            else:
                usage(f"unknown cmdline arg '{a}'")
            i += 1
    except (IndexError, ValueError):
        usage(f"invalid or missing value for '{argv[i - 1] if i else ''}'")
    if not in_path:
        usage("no input file name specified")
    if not out_prefix:
        usage("no output prefix specified")
    if num_parts < 1:
        usage("no part count specified, or invalid -n value")
    if not 1 <= bits <= 10:
        usage(f"--bits must be in [1, 10], got {bits}")

    counts = partition_float3_file(in_path, num_parts, out_prefix, bits)
    for r, c in enumerate(counts):
        print(f"#{r}: {c} points -> {out_prefix}_{r:06d}.float3")
    print(f"file list -> {out_prefix}.txt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
