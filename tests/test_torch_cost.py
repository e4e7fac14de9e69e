"""The port's ``obs/cost.py`` against the JAX package's: ``cost_report``
gives the same dict for the same arguments on the CPU platform, an H100
device kind takes the card's FP32 peak, and ``LSK_PEAK_FLOPS`` overrides
both packages alike. Exact equality throughout."""

import pytest

from mpi_cuda_largescaleknn_torch.obs import cost as t_cost
from mpi_cuda_largescaleknn_tpu.obs import cost as j_cost


@pytest.fixture(autouse=True)
def _no_override(monkeypatch):
    monkeypatch.delenv("LSK_PEAK_FLOPS", raising=False)


@pytest.mark.parametrize("pair_evals,seconds,kind", [
    (0, 0.0, None),
    (1, 1.0, None),
    (123_456_789, 0.731, None),
    (8_388_608 * 2_048, 2.5, "cpu"),
    (10**12, 0.0, None),
])
def test_cost_report_equals_jax_on_cpu(pair_evals, seconds, kind):
    assert t_cost.cost_report(pair_evals, seconds, "cpu", kind) == \
        j_cost.cost_report(pair_evals, seconds, "cpu", kind)


def test_flops_per_pair_equals_jax():
    assert t_cost.FLOPS_PER_PAIR == j_cost.FLOPS_PER_PAIR == 8


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe",
                                  "nvidia h100 nvl"])
def test_h100_kind_takes_the_card_peak(kind):
    assert t_cost.peak_flops("gpu", kind) == 67e12
    rep = t_cost.cost_report(67 * 10**12 // 8, 1.0, "gpu", kind)
    assert rep["assumed_peak_flops"] == 67e12
    assert rep["mfu_estimate"] == 1.0
    assert rep["device_kind"] == kind


def test_platform_fallbacks():
    assert t_cost.peak_flops("gpu") == 67e12
    assert t_cost.peak_flops("cpu") == 1.0e11 == j_cost.peak_flops("cpu")
    assert t_cost.peak_flops("gpu", "Some Other Card") == 67e12
    # no TPU figure: an unknown platform falls back to the card's
    assert t_cost.peak_flops("tpu", "TPU v5 lite") == 67e12


def test_env_override(monkeypatch):
    monkeypatch.setenv("LSK_PEAK_FLOPS", "1.5e13")
    assert t_cost.peak_flops("gpu", "NVIDIA H100 80GB HBM3") == 1.5e13
    assert t_cost.cost_report(10**9, 0.5, "gpu", "NVIDIA H100") == \
        j_cost.cost_report(10**9, 0.5, "gpu", "NVIDIA H100")
    assert t_cost.cost_report(10**9, 0.5, "gpu")[
        "assumed_peak_flops"] == 1.5e13
