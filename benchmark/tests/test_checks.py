"""The check catches what it must, at a size a test run holds, under the
cell's own limits: the run driven with the harness's look for a card
skipped and the timed path broken underneath (a step that returns its
state unchanged; half of the batch left out, the mean over the rest; a
replayed sample altered where the buffer makes it) reads not correct,
and so does the control (``benchmark.control``: the reference in
emulated float8 put in the program's place); the port in float32, the
same mathematics as the reference, reads correct."""

import pytest
import torch

from benchmark import control, judge
from benchmark.tests.small import run_small, small_cell

CELLS = ["kitti360.stream", "cityscapes.pretrain"]
FLOAT32 = {"tpu.compute_dtype": "float32"}
# a seed on which half a small source batch moves the loss terms as far
# as half the published one does (0.18-0.33 on the card)
SEED = 5


def correct(cell, numbers):
    assert cell["limits"]
    return judge.verdict(numbers, cell["limits"])[0]


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_broken_timed_path_is_not_correct(cell_name, fault):
    cell, record = run_small(cell_name, seed=SEED, seconds=0,
                             values=FLOAT32, fault=fault)
    assert not correct(cell, record["numbers"]), record["numbers"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_control_is_not_correct(cell_name):
    cell = small_cell(cell_name, FLOAT32)
    torch.set_num_threads(2)
    numbers = control.readings(cell_name, "fp8", [SEED],
                               torch.device("cpu"), cell=cell)[SEED]
    numbers.pop("readings")
    assert not correct(cell, numbers), numbers


@pytest.mark.parametrize("cell_name", CELLS)
def test_sound_run_is_correct(cell_name):
    cell, record = run_small(cell_name, seed=SEED, seconds=0.5,
                             values=FLOAT32)
    assert correct(cell, record["numbers"]), record["numbers"]
    assert record["attempted"] >= 1


def test_altered_replay_sample_is_not_correct(monkeypatch):
    """A source sample altered where the replay buffer makes it: the
    buffer's draws, worked out again (``reference/replay.py``), catch it."""
    from codeps_torch.data.replay_buffer import ReplayBuffer
    getitem = ReplayBuffer.__getitem__

    def altered(self, index):
        out = getitem(self, index)
        if "source" in out:
            out["source"][0]["rgb"][0] = out["source"][0]["rgb"][0] + 0.5
        return out
    monkeypatch.setattr(ReplayBuffer, "__getitem__", altered)
    cell, record = run_small("kitti360.stream", seed=SEED, seconds=0,
                             values=FLOAT32)
    assert record["numbers"]["side_gap"] > 0.4, record["numbers"]
    assert not correct(cell, record["numbers"])


def test_grouping_check_needs_calls():
    from benchmark.drivers import stream
    assert stream.grouping_mismatch([], 3) == float("inf")
