"""The frozen reference is the port's mathematics: in float32 at a small
size on the CPU, one adaptation stream's checked steps and one
pretraining's checked steps of the port equal the reference's within
float32 rounding, every number the check compares."""

import pytest

from benchmark.tests.small import run_small

FLOAT32 = {"tpu.compute_dtype": "float32"}
ROUNDING = 1e-5


@pytest.mark.parametrize("cell", ["kitti360.stream", "cityscapes.pretrain"])
def test_float32_port_equals_reference(cell):
    _, record = run_small(cell, seconds=0, values=FLOAT32)
    numbers = record["numbers"]
    assert numbers
    for name, value in numbers.items():
        assert value <= ROUNDING, (name, value)
