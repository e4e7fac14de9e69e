"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C launcher, so it compiles in
seconds without PyTorch's headers. The shared library goes to ``build/``
at the root of the checkout, named by a hash of the source, the shared
``csrc/*.cuh`` headers and the flags,
so an edited source rebuilds and an unchanged one loads at once. Nothing is
built at import time: the first launch builds. The naming and the atomic
compile (``library_path``, ``compile_library``) serve the native IO
library's ``g++`` build too (``io/native.py``).
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


def library_path(name: str, text: bytes, flags) -> Path:
    """``build/<name>-<hash>.so``: named by a hash of the source ``text``
    and the compiler ``flags``, so an edited source or flag rebuilds."""
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def compile_library(compiler: str, flags, src: Path, lib: Path) -> str:
    """Compile ``src`` into ``lib`` through a private temporary file
    renamed into place, so a concurrent loader or compile sees all of it
    or none. Returns the compiler's output; raises RuntimeError with it
    when the compiler fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(compiler).name} failed on "
                               f"{src.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stdout + proc.stderr


def build_library(name: str) -> tuple[Path, str, float]:
    """Compile ``csrc/<name>.cu`` unless its build is current. Returns
    (library path, compiler output, seconds spent compiling — 0 when the
    library was already built)."""
    src = CSRC / f"{name}.cu"
    # the shared headers count too: an edited header rebuilds every kernel
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    lib = library_path(name, text, NVCC_FLAGS)
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, log.read_text() if log.exists() else "", 0.0
    t0 = time.perf_counter()
    out = compile_library(_nvcc(), NVCC_FLAGS, src, lib)
    log.write_text(out)
    return lib, out, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, once per process."""
    path, _, _ = build_library(name)
    return ctypes.CDLL(str(path))
