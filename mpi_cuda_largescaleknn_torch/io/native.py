"""ctypes binding of the native IO library (``io/native_io.cpp``).

The library is built at first use with ``g++`` into ``build/`` at the
root of the checkout, named by a hash of its source, flags and machine
(``utils/cuda_build.py`` ``library_path``), and loaded once a process.
Nothing is built when a module is imported.

What runs is never hidden: the readers, the writer and the partitioner
take their numpy paths only where there is no ``g++`` at all
(``available()`` is False). A build that fails raises, and so does a
native call that runs and fails (a short read or write, a partition that
returns -1).
"""

from __future__ import annotations

import ctypes
import functools
import platform
import shutil
from pathlib import Path

import numpy as np

from mpi_cuda_largescaleknn_torch.utils.cuda_build import (
    compile_library,
    library_path,
)

SRC = Path(__file__).resolve().with_name("native_io.cpp")
# -ffp-contract=off: morton3 rounds (x - lo) * inv_ext as the numpy twin
# does; no -march=native or -ffast-math, which would change its bits
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-ffp-contract=off")

_I64, _I32, _STR, _PTR = (ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p,
                          ctypes.c_void_p)
_SIGNATURES = {
    "lsk_read_at": [_STR, _I64, _I64, _PTR, _I32],
    "lsk_create_sized": [_STR, _I64],
    "lsk_write_at": [_STR, _I64, _I64, _PTR],
    "lsk_file_size": [_STR],
    "lsk_partition": [_STR, _I32, _STR, _I32, _PTR],
}


def library_file(src: Path = SRC) -> Path:
    """Where ``src``'s build goes: named by a hash of the source, the
    flags and the machine's architecture (a checkout copied to another
    host builds anew)."""
    return library_path("native_io", src.read_bytes(),
                        GXX_FLAGS + (platform.machine(),))


def build_native(src: Path = SRC) -> Path:
    """Compile ``src`` with ``g++`` unless its build is current; returns
    the library's path. Raises RuntimeError when there is no ``g++`` or
    the compiler fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native IO library needs it")
    lib = library_file(src)
    if not lib.exists():
        compile_library(gxx, GXX_FLAGS, src, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_native()))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = args
    return lib


def available() -> bool:
    """True when the native library is built and loaded; False only where
    there is no ``g++``. A build that fails raises."""
    if shutil.which("g++") is None:
        return False
    _load()
    return True


def native_read_slab(path: str, begin_record: int, num_records: int,
                     num_threads: int = 8) -> np.ndarray:
    """Read ``num_records`` float3 records from record ``begin_record`` of
    ``path`` over ``num_threads`` threads (clamped to 1..64)."""
    out = np.empty((num_records, 3), np.float32)
    nbytes = num_records * 12
    got = _load().lsk_read_at(str(path).encode(), begin_record * 12, nbytes,
                              out.ctypes.data_as(ctypes.c_void_p),
                              num_threads)
    if got != nbytes:
        raise IOError(f"native read of {path} returned {got} != {nbytes}")
    return out


def native_create_sized(path: str, size_bytes: int) -> None:
    """Create or truncate ``path`` at exactly ``size_bytes``: run once
    before concurrent ``native_write_at`` writers, so that a longer file
    left by an earlier run keeps no stale trailing bytes."""
    if _load().lsk_create_sized(str(path).encode(), size_bytes) != 0:
        raise IOError(f"native create of {path} ({size_bytes} bytes) failed")


def native_write_at(path: str, offset_bytes: int, data: np.ndarray) -> None:
    """Write ``data`` at byte ``offset_bytes`` of ``path``, creating it if
    needed; safe for concurrent writers at disjoint offsets. It never
    truncates: pre-size a file that may exist with
    ``native_create_sized``."""
    data = np.ascontiguousarray(data)
    put = _load().lsk_write_at(str(path).encode(), offset_bytes, data.nbytes,
                               data.ctypes.data_as(ctypes.c_void_p))
    if put != data.nbytes:
        raise IOError(f"native write of {path} returned {put} != "
                      f"{data.nbytes}")


def native_partition(in_path: str, num_parts: int, out_prefix: str,
                     bits_per_dim: int = 7) -> np.ndarray:
    """Split a ``.float3`` file into ``num_parts`` spatially coherent
    ``<out_prefix>_%06d.float3`` files along the Morton curve, in three
    streaming passes and O(8^bits) memory, whatever the input's size.
    Returns the per-part counts (i64)."""
    counts = np.zeros(num_parts, np.int64)
    total = _load().lsk_partition(str(in_path).encode(), num_parts,
                                  str(out_prefix).encode(), bits_per_dim,
                                  counts.ctypes.data_as(ctypes.c_void_p))
    if total < 0:
        raise IOError(f"native partition of {in_path} failed")
    return counts
