"""The port's whole slice against the JAX package on the CPU: the one-call
API at R=1 and R=4 (distances bitwise, ids at R=1), and the CLI
(``.float`` output byte-identical). The JAX side runs its fused Pallas
traversal (``engine="pallas_tiled"``) in interpret mode, the engine the
port's ``auto`` stands for."""

import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from mpi_cuda_largescaleknn_torch import kth_neighbor_distances as torch_knn
from mpi_cuda_largescaleknn_torch.cli import partition_main as torch_part_cli
from mpi_cuda_largescaleknn_torch.cli import (
    prepartitioned_main as torch_pre_cli,
)
from mpi_cuda_largescaleknn_torch.cli import unordered_main as torch_cli
from mpi_cuda_largescaleknn_tpu import kth_neighbor_distances as jax_knn
from mpi_cuda_largescaleknn_tpu.cli import prepartitioned_main as jax_pre_cli
from mpi_cuda_largescaleknn_tpu.cli import unordered_main as jax_cli
from tests.oracle import kth_nn_dist, random_points
from tests.test_torch_ops import assert_bitwise


@pytest.mark.parametrize("num_shards,k,radius", [
    (1, 8, math.inf), (1, 100, math.inf), (1, 5, 0.06),
    (4, 8, math.inf), (4, 100, math.inf), (3, 6, math.inf)])
def test_kth_neighbor_distances_match_jax(num_shards, k, radius):
    pts = random_points(600, seed=num_shards * 100 + k)
    want_d, want_i = jax_knn(pts, k, max_radius=radius, num_shards=num_shards,
                             engine="pallas_tiled", bucket_size=16,
                             return_neighbors=True)
    got_d, got_i = torch_knn(pts, k, max_radius=radius,
                             num_shards=num_shards, bucket_size=16,
                             return_neighbors=True, device="cpu")
    assert_bitwise(got_d, np.asarray(want_d))
    if num_shards == 1:
        assert_bitwise(got_i, np.asarray(want_i))
    # and the reference semantics themselves: the oracle within 2 ulp
    np.testing.assert_allclose(got_d, kth_nn_dist(pts, pts, k, radius),
                               rtol=5e-7, atol=1e-37)


def test_shard_count_does_not_change_distances():
    pts = random_points(520, seed=8)
    one = torch_knn(pts, 7, bucket_size=16, device="cpu")
    for r in (2, 4, 5):
        assert_bitwise(torch_knn(pts, 7, num_shards=r, bucket_size=16,
                                 device="cpu"), one)


def test_fewer_points_than_k_gives_inf():
    pts = random_points(10, seed=1)
    assert np.all(np.isinf(torch_knn(pts, 32, device="cpu")))


def test_cli_output_is_byte_identical(tmp_path, capsys):
    pts = random_points(450, seed=12)
    src = tmp_path / "pts.float3"
    pts.tofile(src)
    jax_out, torch_out = tmp_path / "jax.float", tmp_path / "torch.float"
    jax_idx, torch_idx = tmp_path / "jax.int32", tmp_path / "torch.int32"
    common = [str(src), "-k", "9", "--bucket-size", "16"]
    assert jax_cli.main(common + ["-o", str(jax_out), "--engine",
                                  "pallas_tiled", "--shards", "1",
                                  "--write-indices", str(jax_idx)]) == 0
    assert torch_cli.main(common + ["-o", str(torch_out), "--device", "cpu",
                                    "--write-indices", str(torch_idx),
                                    "--selfcheck", "50", "--timings"]) == 0
    assert torch_out.read_bytes() == jax_out.read_bytes()
    assert torch_idx.read_bytes() == jax_idx.read_bytes()
    assert "selfcheck OK (50 samples)" in capsys.readouterr().out


def test_cli_sharded_output_is_byte_identical(tmp_path):
    pts = random_points(333, seed=13)
    src = tmp_path / "pts.float3"
    pts.tofile(src)
    outs = {}
    for shards in (1, 4):
        out = tmp_path / f"torch{shards}.float"
        assert torch_cli.main([str(src), "-o", str(out), "-k", "4",
                               "-r", "0.2", "--bucket-size", "16",
                               "--shards", str(shards), "--device",
                               "cpu"]) == 0
        outs[shards] = out.read_bytes()
    jout = tmp_path / "jax.float"
    assert jax_cli.main([str(src), "-o", str(jout), "-k", "4", "-r", "0.2",
                         "--bucket-size", "16", "--shards", "4",
                         "--engine", "pallas_tiled"]) == 0
    assert outs[1] == outs[4] == jout.read_bytes()


@pytest.mark.parametrize("flag", [["--coordinator", "127.0.0.1:1234"],
                                  ["--num-hosts", "2"],
                                  ["--host-id", "1"]])
def test_cli_refuses_options_not_ported(tmp_path, flag):
    src = tmp_path / "pts.float3"
    random_points(20, seed=0).tofile(src)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_cli.main([str(src), "-o", str(tmp_path / "o.float"), "-k", "2",
                        "--device", "cpu"] + flag)


@pytest.mark.parametrize("flag", [
    ["--query-chunk", "40"],
    ["--checkpoint-dir", "{ckpt}"],
    ["--merge", "device", "--query-chunk", "40"],
    ["--checkpoint-every", "2", "--checkpoint-dir", "{ckpt}",
     "--query-chunk", "24"]])
def test_cli_chunk_merge_checkpoint_flags_match_jax(tmp_path, flag):
    """Each flag on both CLIs, the port's output and id files byte-equal
    to the JAX package's with the same flags."""
    src = tmp_path / "in.float3"
    random_points(280, seed=14).tofile(src)
    assert torch_part_cli.main([str(src), "-n", "4", "-o",
                                str(tmp_path / "part")]) == 0
    common = ["-k", "5", "--bucket-size", "16", "--shards", "4"]
    for name, cli_j, cli_t, inp, out in (
            ("u", jax_cli, torch_cli, src, "{}.float"),
            ("p", jax_pre_cli, torch_pre_cli, tmp_path / "part.txt", "{}")):
        for side, cli, extra in (("j", cli_j, ["--engine", "pallas_tiled"]),
                                 ("t", cli_t, ["--device", "cpu"])):
            tag = tmp_path / f"{name}{side}"
            args = [a.format(ckpt=f"{tag}_ckpt") for a in flag]
            assert cli.main([str(inp), "-o", out.format(tag),
                             "--write-indices", f"{tag}i"] + common + extra
                            + args) == 0
            assert not any(Path(f"{tag}_ckpt").glob("*.npz"))
        outs = [[f for f in sorted(tmp_path.glob(f"{name}{side}*"))
                 if f.is_file()] for side in "jt"]
        assert [p.name[2:] for p in outs[0]] == [p.name[2:] for p in outs[1]]
        for want, got in zip(*outs):
            assert got.read_bytes() == want.read_bytes(), got.name
        assert len(outs[0]) == (2 if name == "u" else 8)


def test_cli_profile_dir_writes_a_trace(tmp_path):
    """``--profile-dir`` traces the run with torch.profiler into a Chrome
    trace and changes no output byte."""
    src = tmp_path / "pts.float3"
    random_points(300, seed=4).tofile(src)
    outs = []
    for extra in ([], ["--profile-dir", str(tmp_path / "prof")]):
        out = tmp_path / f"o{len(extra)}.float"
        assert torch_cli.main([str(src), "-o", str(out), "-k", "4",
                               "--bucket-size", "16", "--device", "cpu"]
                              + extra) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    traces = list((tmp_path / "prof").glob("trace-*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_device_summary_unions_device_intervals():
    """The busy share counts overlapping device intervals once and host
    events not at all; the top kernels are ordered by device time."""
    from torch.autograd import DeviceType

    from mpi_cuda_largescaleknn_torch.obs.trace import device_summary

    def ev(start, end, device=DeviceType.CUDA):
        return SimpleNamespace(time_range=SimpleNamespace(start=start,
                                                          end=end),
                               device_type=device)

    def avg(key, us, count, device=DeviceType.CUDA):
        return SimpleNamespace(key=key, self_device_time_total=us,
                               count=count, device_type=device)

    prof = SimpleNamespace(
        events=lambda: [ev(0, 400, DeviceType.CPU), ev(100, 200),
                        ev(150, 300), ev(500, 600)],
        key_averages=lambda: [avg("aten::add", 0, 3, DeviceType.CPU),
                              avg("small", 100, 1), avg("big", 250, 2)])
    got = device_summary(prof, seconds=0.001)
    assert got["device_seconds"] == pytest.approx(300e-6)
    assert got["busy_share"] == pytest.approx(0.3)
    assert [r["name"] for r in got["top"]] == ["big", "small"]
    assert got["top"][0] == {"name": "big", "ms": 0.25, "calls": 2}
    none = device_summary(SimpleNamespace(events=lambda: [],
                                          key_averages=lambda: []), 1.0)
    assert none == {"device_seconds": None, "busy_share": None, "top": []}


def test_cli_usage_errors(tmp_path):
    with pytest.raises(SystemExit):
        torch_cli.main(["-k", "2", "-o", str(tmp_path / "o.float")])
    with pytest.raises(SystemExit):
        torch_cli.main(["x.float3", "-o", "o.float", "--bogus"])
