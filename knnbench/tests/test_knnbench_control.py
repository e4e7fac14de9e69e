"""The control of each cell's check, the reference in the precision below
the configuration's, comes out as not correct: bfloat16 at D=3 here on the
CPU, and on the card TF32 at D=128 as well, at sizes a test run holds.
``python3 -m knnbench.control`` runs the same at the cells' own sizes."""

import json

import pytest
import torch

from knnbench.control import control_numbers
from knnbench.spec import load_cell


def _fails(numbers):
    return any(c["value"] > c["limit"] for c in numbers.values())


@pytest.mark.parametrize("cell", ["tiny-sj", "tiny-serve", "tiny-ring"])
def test_bf16_control_fails_the_d3_cells(tiny_root, cell):
    c = load_cell(cell, tiny_root)
    assert c.config["control_precision"] == "bf16"
    for seed in (1, 2, 3):
        numbers = control_numbers(c, seed, torch.device("cpu"), samples=256,
                                  seconds=3.0)
        assert _fails(numbers), numbers


def test_the_reference_in_its_own_place_passes(tiny_root):
    c = load_cell("tiny-sj", tiny_root)
    numbers = control_numbers(c, 1, torch.device("cpu"), samples=256,
                              precision="f64")
    assert not _fails(numbers), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["selfjoin-sift1m-k10", "selfjoin-3d-k100"])
def test_controls_fail_on_the_card(tiny_root, card, cell):
    c = load_cell(cell, tiny_root)
    c.config["points_per_rank"] = 65536
    for seed in (1, 2, 3):
        numbers = control_numbers(c, seed, card, samples=256)
        assert _fails(numbers), json.dumps(numbers)
