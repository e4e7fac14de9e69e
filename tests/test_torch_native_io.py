"""The port's native out-of-core IO (``io/native_io.cpp`` through
``io/native.py``) against the JAX package on the CPU: part files of the
streaming partitioner byte-identical to JAX's native partitioner and to
both packages' numpy twins, slab reads and slab writes equal to JAX's, and
no fallback that hides what ran. Tests that build the library skip where
there is no ``g++``."""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mpi_cuda_largescaleknn_torch.io import native
from mpi_cuda_largescaleknn_torch.io import partition_file as tpf
from mpi_cuda_largescaleknn_torch.io import reader as treader
from mpi_cuda_largescaleknn_torch.io import writer as twriter
from mpi_cuda_largescaleknn_torch.utils import cuda_build
from mpi_cuda_largescaleknn_tpu.io import native as jnative
from mpi_cuda_largescaleknn_tpu.io import partition_file as jpf
from mpi_cuda_largescaleknn_tpu.io import reader as jreader
from mpi_cuda_largescaleknn_tpu.io import writer as jwriter

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the native IO library needs g++")

#: one more point than the partitioner's read buffer (2^20) holds
BIG = (1 << 20) + 5


def seeded(n: int, seed: int, kind: str = "uniform") -> np.ndarray:
    rng = np.random.default_rng(seed)
    pts = (rng.random((n, 3), dtype=np.float32) * 8.0 - 2.0)
    if kind == "identical":
        pts[:] = pts[:1] if n else pts
    elif kind == "flat":
        pts[:, 1] = 0.25                        # zero extent in y
    return pts


def without_gxx(monkeypatch) -> None:
    """Make the port see no ``g++`` (``available()`` is then False)."""
    real = shutil.which
    monkeypatch.setattr(shutil, "which",
                        lambda name, *a, **kw: None if name == "g++"
                        else real(name, *a, **kw))


def part_bytes(prefix, parts: int) -> list[bytes]:
    return [Path(f"{prefix}_{r:06d}.float3").read_bytes()
            for r in range(parts)]


def check_partition(tmp_path, pts: np.ndarray, parts: int, bits: int):
    src = tmp_path / "in.float3"
    pts.tofile(src)
    prefixes = {name: tmp_path / name for name in ("t", "j", "tn", "jn")}
    got = {
        # the port's and JAX's dispatchers, both native here
        "t": tpf.partition_float3_file(str(src), parts, str(prefixes["t"]),
                                       bits),
        "j": jpf.partition_float3_file(str(src), parts, str(prefixes["j"]),
                                       bits),
        "tn": tpf.partition_float3_file_np(str(src), parts,
                                           str(prefixes["tn"]), bits),
        "jn": jpf.partition_float3_file_np(str(src), parts,
                                           str(prefixes["jn"]), bits),
    }
    for name, counts in got.items():
        assert np.asarray(counts).dtype == np.int64
        np.testing.assert_array_equal(counts, got["j"], err_msg=name)
    assert int(got["t"].sum()) == len(pts)
    want = part_bytes(prefixes["j"], parts)
    assert sum(map(len, want)) == pts.nbytes
    for name in ("t", "tn", "jn"):
        assert part_bytes(prefixes[name], parts) == want, name
    for name in ("t", "j"):
        listed = Path(f"{prefixes[name]}.txt").read_text().splitlines()
        assert listed == [f"{prefixes[name]}_{r:06d}.float3"
                          for r in range(parts)]


@needs_gxx
@pytest.mark.parametrize("bits", [1, 4, 7])
@pytest.mark.parametrize("parts", [1, 3, 8])
@pytest.mark.parametrize("n", [0, 1, 7, 1000, BIG])
def test_part_files_match_jax_native_and_numpy(tmp_path, n, parts, bits):
    check_partition(tmp_path, seeded(n, seed=n + 31 * parts), parts, bits)


@needs_gxx
@pytest.mark.parametrize("kind,n,parts", [
    ("identical", 500, 4),       # extent 0 on every axis
    ("flat", 2000, 5),           # extent 0 on one axis
    ("uniform", 3, 8),           # fewer points than parts
])
def test_part_files_match_jax_on_degenerate_input(tmp_path, kind, n, parts):
    check_partition(tmp_path, seeded(n, seed=7, kind=kind), parts, 7)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_partition_without_file_list(tmp_path, monkeypatch, path):
    if path == "native" and shutil.which("g++") is None:
        pytest.skip("the native IO library needs g++")
    if path == "numpy":
        without_gxx(monkeypatch)
    pts = seeded(500, seed=4)
    src = tmp_path / "in.float3"
    pts.tofile(src)
    got = tpf.partition_float3_file(str(src), 3, str(tmp_path / "t"),
                                    write_file_list=False)
    want = jpf.partition_float3_file(str(src), 3, str(tmp_path / "j"),
                                     write_file_list=False)
    np.testing.assert_array_equal(got, want)
    assert part_bytes(tmp_path / "t", 3) == part_bytes(tmp_path / "j", 3)
    assert not (tmp_path / "t.txt").exists()


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_partition_refuses_a_partial_record(tmp_path, monkeypatch, path):
    src = tmp_path / "bad.float3"
    src.write_bytes(seeded(10, seed=1).tobytes() + b"\0" * 5)
    if path == "native":
        if shutil.which("g++") is None:
            pytest.skip("the native IO library needs g++")
        with pytest.raises(IOError):
            jnative.native_partition(str(src), 2, str(tmp_path / "j"))
    else:
        without_gxx(monkeypatch)
        with pytest.raises(IOError):
            jpf.partition_float3_file_np(str(src), 2, str(tmp_path / "j"))
    with pytest.raises(IOError):
        tpf.partition_float3_file(str(src), 2, str(tmp_path / "t"))


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("rank,size", [(0, 1), (2, 3), (6, 7)])
def test_read_file_portion_matches_jax(tmp_path, monkeypatch, path, rank,
                                       size):
    if path == "native" and shutil.which("g++") is None:
        pytest.skip("the native IO library needs g++")
    pts = seeded(100_003, seed=5)
    src = tmp_path / "pts.float3"
    pts.tofile(src)
    if path == "numpy":
        without_gxx(monkeypatch)
        assert not native.available()
    got, begin, total = treader.read_file_portion(str(src), rank, size)
    want, wbegin, wtotal = jreader.read_file_portion(str(src), rank, size)
    assert (begin, total) == (wbegin, wtotal)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == pts[begin:len(pts) * (rank + 1) // size].tobytes()


@needs_gxx
@pytest.mark.parametrize("threads", [1, 3, 64, 100])
def test_native_read_slab_comes_back_whole(tmp_path, threads):
    # counts that do not divide evenly among the threads, and counts
    # smaller than the thread count (where the JAX package's copy reads
    # short: its late threads count a negative share)
    pts = seeded(BIG, seed=6)
    src = tmp_path / "pts.float3"
    pts.tofile(src)
    for begin, count in ((0, 0), (0, 1), (3, 2), (7, 5), (11, 1000),
                         (0, BIG), (BIG - 1001, 1001)):
        got = native.native_read_slab(str(src), begin, count, threads)
        assert got.tobytes() == pts[begin:begin + count].tobytes()
        nbytes, t = count * 12, min(threads, 64)
        if (t - 1) * -(-nbytes // t) <= nbytes:   # JAX reads it whole
            want = jnative.native_read_slab(str(src), begin, count, threads)
            assert got.tobytes() == want.tobytes()
    with pytest.raises(IOError, match="native read"):
        native.native_read_slab(str(src), BIG - 1, 2, threads)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_write_distances_slab_matches_jax(tmp_path, monkeypatch, path):
    if path == "native" and shutil.which("g++") is None:
        pytest.skip("the native IO library needs g++")
    if path == "numpy":
        without_gxx(monkeypatch)
    d = np.random.default_rng(8).random(1003, dtype=np.float32)
    d[5] = np.inf
    slabs = [(0, 334), (334, 668), (668, 1003)]
    for name, write in (("t.float", twriter.write_distances_slab),
                        ("j.float", jwriter.write_distances_slab)):
        out = tmp_path / name
        # a stale longer file from an earlier run
        out.write_bytes(b"\xff" * (4 * len(d) + 64))
        write(str(out), 0, d[:334], len(d), presize=True)
        for b, e in reversed(slabs[1:]):
            write(str(out), b, d[b:e], len(d))
    got = (tmp_path / "t.float").read_bytes()
    assert got == (tmp_path / "j.float").read_bytes() == d.tobytes()
    # without presize an existing file keeps its length; with it, truncated
    twriter.write_distances_slab(str(tmp_path / "t.float"), 0, d[:10], 10)
    assert (tmp_path / "t.float").stat().st_size == d.nbytes
    twriter.write_distances_slab(str(tmp_path / "t.float"), 0, d[:10], 10,
                                 presize=True)
    assert (tmp_path / "t.float").read_bytes() == d[:10].tobytes()


@needs_gxx
def test_native_failures_raise_and_do_not_fall_back(tmp_path, monkeypatch):
    pts = seeded(32, seed=3)
    src = tmp_path / "pts.float3"
    pts.tofile(src)

    def short_read(*a, **kw):
        raise IOError("native read returned 7 != 384")

    def no_numpy(*a, **kw):
        raise AssertionError("the numpy path ran after a native failure")

    with monkeypatch.context() as m:
        m.setattr(native, "native_read_slab", short_read)
        with pytest.raises(IOError, match="native read"):
            treader.read_file_portion(str(src), 0, 1)
    monkeypatch.setattr(tpf, "partition_float3_file_np", no_numpy)
    # lsk_partition returns -1: its part files cannot be created
    with pytest.raises(IOError, match="native partition"):
        tpf.partition_float3_file(str(src), 2,
                                  str(tmp_path / "missing" / "p"))
    with pytest.raises(IOError, match="native partition"):
        tpf.partition_float3_file(str(tmp_path / "absent.float3"), 2,
                                  str(tmp_path / "p"))
    with pytest.raises(IOError, match="native write"):
        native.native_write_at(str(tmp_path / "missing" / "o.float"), 0,
                               np.zeros(4, np.float32))
    with pytest.raises(IOError, match="native create"):
        native.native_create_sized(str(tmp_path / "missing" / "o.float"), 16)


def test_numpy_paths_run_only_without_gxx(tmp_path, monkeypatch):
    without_gxx(monkeypatch)
    assert not native.available()

    def no_native(*a, **kw):
        raise AssertionError("the native library was asked for")

    monkeypatch.setattr(native, "_load", no_native)
    pts = seeded(2000, seed=9)
    src = tmp_path / "pts.float3"
    pts.tofile(src)
    got, _, _ = treader.read_file_portion(str(src), 1, 2)
    assert got.tobytes() == pts[1000:].tobytes()
    counts = tpf.partition_float3_file(str(src), 3, str(tmp_path / "t"))
    want = jpf.partition_float3_file_np(str(src), 3, str(tmp_path / "j"))
    np.testing.assert_array_equal(counts, want)
    assert part_bytes(tmp_path / "t", 3) == part_bytes(tmp_path / "j", 3)
    twriter.write_distances_slab(str(tmp_path / "o.float"), 0,
                                 pts[:, 0], 2000, presize=True)
    assert (tmp_path / "o.float").read_bytes() == pts[:, 0].tobytes()


@needs_gxx
def test_a_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on broken.cpp"):
        native.build_native(broken)
    # available() does not swallow it
    monkeypatch.setattr(native, "GXX_FLAGS",
                        native.GXX_FLAGS + ("-fno-such-flag",))
    native._load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.available()
    finally:
        native._load.cache_clear()


@needs_gxx
def test_library_lands_in_build_not_in_the_package():
    lib = native.build_native()
    assert lib.parent == cuda_build.BUILD_DIR
    assert lib.name.startswith("native_io-") and lib.suffix == ".so"
    assert native.available()
    pkg = Path(native.__file__).parent
    assert not list(pkg.glob("*.so"))


@needs_gxx
def test_two_processes_build_and_load_at_once(tmp_path):
    # a source no process has built yet, so both children compile it
    src = tmp_path / "native_io.cpp"
    src.write_text(native.SRC.read_text()
                   + f"\n// {tmp_path.name} {np.random.default_rng().random()}\n")
    probe = tmp_path / "pts.float3"
    seeded(100, seed=2).tofile(probe)
    code = (
        "import ctypes, sys\n"
        "from pathlib import Path\n"
        "from mpi_cuda_largescaleknn_torch.io import native\n"
        "lib = ctypes.CDLL(str(native.build_native(Path(sys.argv[1]))))\n"
        "lib.lsk_file_size.restype = ctypes.c_int64\n"
        "lib.lsk_file_size.argtypes = [ctypes.c_char_p]\n"
        "print(lib.lsk_file_size(sys.argv[2].encode()))\n")
    root = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(src),
                               str(probe)], cwd=root, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    lib = native.library_file(src)
    try:
        for p, (out, err) in zip(procs, outs):
            assert p.returncode == 0, err
            assert out.strip() == "1200"
        assert lib.exists()
        ctypes.CDLL(str(lib))
    finally:
        lib.unlink(missing_ok=True)
