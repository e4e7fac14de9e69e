"""The port's phases as profiler spans (``obs/timers.py``): ``lsk.<phase>``
spans nested as the phases are, entered only while a profiler records;
device spans timed by event pairs and settled by the ring's stages; the
spans of a self-join job (``upload``, ``box_order``, ``download``); the
benchmark's readers of them; ``Mesh.exchange_seconds`` on event pairs
under NCCL. CPU only: the card's event pairs are stood in for by fakes."""

import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mpi_cuda_largescaleknn_torch.core.config import KnnConfig
from mpi_cuda_largescaleknn_torch.models.unordered import UnorderedKNN
from mpi_cuda_largescaleknn_torch.obs import timers as t_timers
from mpi_cuda_largescaleknn_torch.obs.timers import EventPairs, PhaseTimers
from mpi_cuda_largescaleknn_torch.parallel.mesh import Mesh
from mpi_cuda_largescaleknn_torch.parallel.ring import timed_stage

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CPU = torch.device("cpu")


def _lsk_events(prof) -> dict:
    return {e.name: e for e in prof.events() if e.name.startswith("lsk.")}


def test_phases_are_nested_profiler_spans_on_the_host_clock():
    timers = PhaseTimers()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timers.phase("a"):
            with timers.phase("b"):
                torch.ones(4).sum()
    ev = _lsk_events(prof)
    a, b = ev["lsk.a"], ev["lsk.b"]
    assert b.cpu_parent is a
    assert (a.time_range.start <= b.time_range.start
            and b.time_range.end <= a.time_range.end)
    assert timers.phases["a"].seconds >= timers.phases["b"].seconds > 0
    assert timers.phases["a"].calls == timers.phases["b"].calls == 1


def test_no_span_is_entered_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not t_timers.profiling()
    timers = PhaseTimers()
    with timers.phase("a"), timers.device_span("b", CPU):
        pass
    assert timers.phases["a"].calls == timers.phases["b"].calls == 1


def test_a_device_span_is_in_its_phase_by_the_end_of_the_stage():
    timers = PhaseTimers()
    with timed_stage(timers, "stage", CPU):
        with timers.device_span("span", CPU):
            time.sleep(0.002)
    assert timers.phases["span"].seconds >= 0.002
    assert timers.phases["span"].calls == 1
    assert timers.phases["stage"].seconds >= timers.phases["span"].seconds


class FakeEvent:
    """A ``torch.cuda.Event`` whose completion the test decides: ``record``
    stamps the host clock, ``query`` says whether ``done`` is set."""

    done = False

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def query(self):
        return FakeEvent.done

    def synchronize(self):
        FakeEvent.done = True

    def elapsed_time(self, end):
        assert FakeEvent.done
        return (end.t - self.t) * 1e3


@pytest.fixture
def fake_card(monkeypatch):
    FakeEvent.done = False
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    return torch.device("cuda", 0)


def test_card_spans_wait_for_settle_and_add_no_synchronise(fake_card,
                                                           monkeypatch):
    timers = PhaseTimers()
    with timers.device_span("box_order", fake_card):
        time.sleep(0.002)
    # the pair is pending: nothing waits for it
    assert timers.phases.get("box_order") is None
    timers.settle()
    assert timers.phases.get("box_order") is None
    FakeEvent.done = True
    timers.settle()
    rec = timers.phases["box_order"]
    assert rec.calls == 1 and rec.seconds >= 0.002
    timers.settle()
    assert rec.calls == 1


def test_timed_stage_settles_card_spans(fake_card, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device)
                        or setattr(FakeEvent, "done", True))
    timers = PhaseTimers()
    with timed_stage(timers, "traverse", fake_card):
        for _ in range(3):
            with timers.device_span("box_order", fake_card):
                pass
    assert calls == [fake_card]
    assert timers.phases["box_order"].calls == 3


def test_event_pairs_keep_the_unfinished_ones(fake_card):
    pairs = EventPairs()
    with pairs.span("x"):
        pass
    assert pairs.settle() == []
    got = pairs.settle(wait=True)
    assert [k for k, _ in got] == ["x"] and got[0][1] >= 0
    assert pairs.settle(wait=True) == []


def test_a_job_has_upload_download_and_box_order_spans():
    pts = np.random.default_rng(7).random((3000, 3), dtype=np.float32)
    model = UnorderedKNN(KnnConfig(k=8, device="cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.run(pts)
    for name in ("upload", "download", "box_order", "shard_and_pad", "trim",
                 "partition", "warm_start", "traverse", "extract"):
        assert model.timers.phases[name].seconds > 0, name
    ev = _lsk_events(prof)
    assert ev["lsk.upload"].cpu_parent is ev["lsk.ring"]
    assert ev["lsk.download"].cpu_parent is ev["lsk.ring"]
    assert ev["lsk.box_order"].cpu_parent is ev["lsk.traverse"]
    assert ev["lsk.trim"].cpu_parent is None


def _record(stages: dict, jobs: int = 4) -> dict:
    # as knnbench/drivers.py run_jobs builds it
    return {"jobs": jobs, "window_s": 1.0, "points_per_job": 3000, "dim": 3,
            "k": 8, "stages": stages, "setup_parts": {}, "trace": None,
            "traced_jobs": 0}


READERS = {
    "model.host_s.selfjoin": ("shard_and_pad", "download", "trim"),
    "stage.upload_s.selfjoin": ("upload",),
    "stage.box_order_s.selfjoin": ("box_order",),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_readers_read_a_job_record(name):
    from knnbench.spec import metric_reader

    read = metric_reader(name)
    model = UnorderedKNN(KnnConfig(k=8, device="cpu"))
    model.run(np.random.default_rng(3).random((2000, 3), dtype=np.float32))
    stages = {k: r.seconds for k, r in model.timers.phases.items()}
    got = read(_record(stages))
    want = sum(stages[p] for p in READERS[name]) / 4
    assert np.isfinite(got) and got == pytest.approx(want) and got > 0
    for missing in READERS[name]:
        assert read(_record({k: v for k, v in stages.items()
                             if k != missing})) is None
    assert read(_record(stages, jobs=0)) is None


def test_mesh_exchange_on_nccl_is_timed_by_event_pairs(fake_card):
    mesh = Mesh(2, CPU, grouped=False)
    mesh.backend = "nccl"
    with mesh._exchange():
        time.sleep(0.002)
    # the host did not wait: the pair is read when the figure is
    assert mesh._exchange_s == 0.0
    assert mesh.exchange_seconds >= 0.002
    # finished pairs are folded in by the next exchange
    FakeEvent.done = False
    with mesh._exchange():
        pass
    FakeEvent.done = True
    seconds = mesh.exchange_seconds
    with mesh._exchange():
        time.sleep(0.001)
    assert mesh._exchange_s >= seconds + 0.001
    mesh.exchange_seconds = 0.0
    assert mesh.exchange_seconds == 0.0


def test_mesh_exchange_on_gloo_keeps_the_host_clock(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("no event pair on gloo")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    mesh = Mesh(2, CPU, grouped=False)
    mesh.backend = "gloo"
    with mesh._exchange():
        time.sleep(0.002)
    assert mesh.exchange_seconds >= 0.002


class Ev:
    """A profiler event: host (CPU) or device (CUDA), with its correlation
    id, time range in microseconds and host parent."""

    def __init__(self, name, start, end, parent=None, device=False, id=0):
        self.name, self.cpu_parent, self.id = name, parent, id
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = (torch.autograd.DeviceType.CUDA if device
                            else torch.autograd.DeviceType.CPU)


def test_span_breakdown_puts_each_device_op_under_its_launching_span():
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import torch_span_breakdown as tool
    finally:
        sys.path.remove(str(ROOT / "tools"))
    win = Ev("knnbench.window", 0, 1000)
    ring = Ev("lsk.ring", 10, 900)
    warm = Ev("lsk.warm_start", 20, 300, ring)
    trav = Ev("lsk.traverse", 400, 800, ring)
    box = Ev("lsk.box_order", 410, 500, trav)
    events = [
        win, ring, warm, trav, box,
        # a sort launched by an operator in the warm start and in the box
        # order, a kernel launched by no operator in the traversal, a copy
        # launched outside the window, and a kernel with no launch
        Ev("aten::sort", 30, 40, warm), Ev("cudaLaunchKernel", 31, 32, id=7),
        Ev("radixSort", 50, 250, device=True, id=7),
        Ev("cudaLaunchKernel", 420, 421, id=8),
        Ev("radixSort", 430, 530, device=True, id=8),
        Ev("cudaLaunchKernel", 600, 601, id=9),
        Ev("d3_kernel", 610, 690, device=True, id=9),
        Ev("cudaMemcpyAsync", 1100, 1101, id=10),
        Ev("Memcpy DtoH", 1100, 1300, device=True, id=10),
        Ev("orphan", 700, 701, device=True, id=11),
    ]
    by = tool.device_by_span(events, "knnbench.window")
    assert by == {
        "radixSort": {"lsk.ring/lsk.warm_start": 200e-6,
                      "lsk.ring/lsk.traverse/lsk.box_order": 100e-6},
        "d3_kernel": {"lsk.ring/lsk.traverse": 80e-6},
        "orphan": {"(unmatched)": 1e-6}}
    top = tool.top_ops(by, 1, per_job=2)
    assert top == [{"op": "radixSort", "s_per_job": pytest.approx(150e-6),
                    "spans": {"lsk.ring/lsk.warm_start": 100e-6,
                              "lsk.ring/lsk.traverse/lsk.box_order": 50e-6}}]
