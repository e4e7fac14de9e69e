"""Whether an edit moved a kernel's machine code: SASS of two checkouts.

Builds ``csrc/<name>.cu`` of this checkout and of another one (``--other``,
say the parent commit unpacked with ``git archive``) with the package's
nvcc flags, dumps each library with ``cuobjdump -sass``, and compares the
instructions of every kernel whose name matches ``--kernels`` (a regular
expression on the demangled-enough name), with addresses, the anonymous
namespace's per-file tag and comments taken out. Prints one line a kernel
(identical, differs, or only in one checkout) and exits 1 if any kernel
named differs, or if none is found. By default it compares the D=3
kernels' instances of 1, 2 and 4 slots a lane, the ones the launchers
dispatch to. Needs ``nvcc`` and ``cuobjdump`` (no card):

    python3 tools/torch_sass_compare.py --other DIR [--kernels REGEX]
        [--out FILE.json]
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCES = ("knn_tiled", "knn_bf")
#: knn_tiled_d3_kernel<S> and knn_bf_d3_kernel<S>, S in 1, 2, 4, mangled
#: (``ILi1E``) or not (``<1>``)
D3_INSTANCES = r"knn_(tiled|bf)_d3_kernel(ILi[124]E|<[124]>)"


def sass(lib: Path) -> dict:
    """{kernel: [instructions]} of a library's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    kernels, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            # the anonymous namespace's tag names the file and its build
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "anon", m.group(1))
            kernels[name] = []
            continue
        if name is None:
            continue
        code = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line.split(";")[0]).strip()
        if code and not code.startswith(".") and not code.startswith("//"):
            kernels[name].append(code)
    return kernels


def build(checkout: Path, name: str, out_dir: Path) -> Path:
    from mpi_cuda_largescaleknn_torch.utils.cuda_build import (
        NVCC_FLAGS,
        _nvcc,
    )

    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"{name}.so"
    src = checkout / "mpi_cuda_largescaleknn_torch" / "csrc" / f"{name}.cu"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
                   capture_output=True, text=True, check=True)
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="the other checkout")
    ap.add_argument("--kernels", default=D3_INSTANCES,
                    help="regular expression of the kernels compared")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    pick = re.compile(args.kernels)
    work = ROOT / "build" / "sass_compare"
    result, moved = {}, False
    for name in SOURCES:
        here = sass(build(ROOT, name, work / "this"))
        there = sass(build(Path(args.other).resolve(), name, work / "other"))
        for kern in sorted(set(here) | set(there)):
            if not pick.search(kern):
                continue
            if kern not in here or kern not in there:
                verdict = "only in " + ("this" if kern in here else "other")
            elif here[kern] == there[kern]:
                verdict = f"identical ({len(here[kern])} instructions)"
            else:
                verdict = "differs"
                moved = True
            result[kern] = verdict
            print(f"{kern}: {verdict}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    if not result:
        print(f"no kernel matches {args.kernels!r}", flush=True)
        return 1
    return 1 if moved else 0


if __name__ == "__main__":
    sys.exit(main())
