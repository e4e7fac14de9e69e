"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C launcher, so it compiles in
seconds without PyTorch's headers. The shared library goes to ``build/``
at the root of the checkout, named by a hash of the source, the shared
``csrc/*.cuh`` headers and the flags,
so an edited source rebuilds and an unchanged one loads at once. Nothing is
built at import time: the first launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

# -fmad=false: no multiply-add contraction anywhere, so every distance is
# the correctly rounded ((dx*dx + dy*dy) + dz*dz) of the reference scorer
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def build_library(name: str) -> tuple[Path, str, float]:
    """Compile ``csrc/<name>.cu`` unless its build is current. Returns
    (library path, compiler output, seconds spent compiling — 0 when the
    library was already built)."""
    src = CSRC / f"{name}.cu"
    # the shared headers count too: an edited header rebuilds every kernel
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    lib = BUILD_DIR / f"{name}-{digest}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, log.read_text() if log.exists() else "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)   # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    out = proc.stdout + proc.stderr
    log.write_text(out)
    return lib, out, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, once per process."""
    path, _, _ = build_library(name)
    return ctypes.CDLL(str(path))
