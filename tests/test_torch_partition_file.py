"""The port's partition tool and pre-partitioned file IO against the JAX
package on the CPU: part files byte-identical to JAX
``partition_float3_file_np``, Morton codes equal, and the readers and
writers of the pre-partitioned CLI."""

import numpy as np
import pytest

from mpi_cuda_largescaleknn_torch.cli import partition_main as torch_cli
from mpi_cuda_largescaleknn_torch.io import partition_file as tpf
from mpi_cuda_largescaleknn_torch.io import reader as treader
from mpi_cuda_largescaleknn_torch.io import writer as twriter
from mpi_cuda_largescaleknn_torch.utils import math as tmath
from mpi_cuda_largescaleknn_tpu.io import partition_file as jpf
from mpi_cuda_largescaleknn_tpu.io import reader as jreader
from mpi_cuda_largescaleknn_tpu.utils import math as jmath
from tests.oracle import random_points
from tests.test_torch_ops import assert_bitwise


def test_part1by2_matches_jax():
    v = np.concatenate([np.arange(4096, dtype=np.uint64),
                        np.random.default_rng(0).integers(
                            0, 1 << 21, 5000).astype(np.uint64),
                        np.array([(1 << 21) - 1, 1 << 22], np.uint64)])
    assert_bitwise(tmath._part1by2(v), jmath._part1by2(v))


@pytest.mark.parametrize("bits", [1, 7, 10])
def test_morton_codes_match_jax(bits):
    pts = random_points(2000, seed=bits, scale=3.0)
    lo = pts.min(axis=0)
    ext = pts.max(axis=0) - lo
    inv = (np.float32(1.0) / ext).astype(np.float32)
    assert_bitwise(tpf.morton_codes(pts, lo, inv, bits),
                   jpf.morton_codes(pts, lo, inv, bits))


@pytest.mark.parametrize("n,parts,bits,kind", [
    (3000, 4, 7, "uniform"), (3000, 8, 7, "clustered"), (777, 3, 5, "uniform"),
    (10, 16, 7, "uniform"), (500, 1, 7, "flat"), (0, 4, 7, "uniform")])
def test_part_files_match_jax(tmp_path, n, parts, bits, kind):
    pts = random_points(n, seed=n + parts, scale=2.0)
    if kind == "clustered":
        pts[: n // 2] *= 0.01
    if kind == "flat":
        pts[:, 2] = 0.5                        # zero extent in z
    src = tmp_path / "in.float3"
    pts.tofile(src)
    want = jpf.partition_float3_file_np(str(src), parts, str(tmp_path / "j"),
                                        bits)
    got = tpf.partition_float3_file(str(src), parts, str(tmp_path / "t"),
                                    bits)
    assert_bitwise(got, np.asarray(want))
    assert got.sum() == n
    for r in range(parts):
        assert (tmp_path / f"t_{r:06d}.float3").read_bytes() == \
            (tmp_path / f"j_{r:06d}.float3").read_bytes()
    names = (tmp_path / "t.txt").read_text().split()
    assert names == [f"{tmp_path / 't'}_{r:06d}.float3" for r in range(parts)]


def test_partition_refuses_bad_input(tmp_path):
    src = tmp_path / "bad.float3"
    src.write_bytes(b"\0" * 13)
    with pytest.raises(IOError):
        tpf.partition_float3_file(str(src), 2, str(tmp_path / "p"))
    random_points(10).tofile(src)
    with pytest.raises(ValueError):
        tpf.partition_float3_file(str(src), 0, str(tmp_path / "p"))
    with pytest.raises(ValueError):
        tpf.partition_float3_file(str(src), 2, str(tmp_path / "p"), 11)


def test_partition_cli(tmp_path, capsys):
    src = tmp_path / "in.float3"
    random_points(400, seed=2).tofile(src)
    assert torch_cli.main([str(src), "-n", "4", "-o",
                           str(tmp_path / "p"), "--bits", "6"]) == 0
    out = capsys.readouterr().out
    assert out.count("points ->") == 4 and "p.txt" in out
    got = np.concatenate([treader.read_points(f) for f in
                          treader.read_list_of_file_names(
                              str(tmp_path / "p.txt"))])
    assert sorted(map(tuple, got.tolist())) == sorted(
        map(tuple, random_points(400, seed=2).tolist()))
    for bad in (["-n", "4", "-o", "x"], [str(src), "-o", "x"],
                [str(src), "-n", "2"], [str(src), "-n", "2", "-o", "x",
                                        "--bits", "0"],
                [str(src), "--bogus"]):
        with pytest.raises(SystemExit):
            torch_cli.main(bad)


def test_readers_match_jax(tmp_path):
    pts = random_points(50, seed=4)
    pts.tofile(tmp_path / "a.float3")
    np.save(tmp_path / "b.npy", pts[:, :2].astype(np.float64))
    for name in ("a.float3", "b.npy"):
        assert_bitwise(treader.read_points(str(tmp_path / name)),
                       jreader.read_points(str(tmp_path / name)))
    np.save(tmp_path / "c.npy", pts.reshape(-1))
    with pytest.raises(ValueError, match="expected an"):
        treader.read_points(str(tmp_path / "c.npy"))
    lst = tmp_path / "files.txt"
    lst.write_text("a.float3\n\n  b.npy  \nlast")
    assert treader.read_list_of_file_names(str(lst)) == \
        jreader.read_list_of_file_names(str(lst)) == \
        ["a.float3", "b.npy", "last"]


def test_rank_writers(tmp_path):
    prefix = str(tmp_path / "out")
    d = np.array([0.5, np.inf], np.float32)
    ids = np.array([[1, -1], [0, 1]], np.int32)
    assert twriter.write_rank_file(prefix, 3, d) == f"{prefix}_000003.float"
    assert twriter.write_rank_indices(prefix, 3, ids) == \
        f"{prefix}_000003.int32"
    assert (tmp_path / "out_000003.float").read_bytes() == d.tobytes()
    assert (tmp_path / "out_000003.int32").read_bytes() == ids.tobytes()
