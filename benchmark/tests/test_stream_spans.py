"""The readers of the program's spans inside the stream: the right mean on
a synthetic record, a value in a small run on the CPU that fits inside
the phase it splits, and a finite number in a traced run on a card.

    python3 -m pytest benchmark/tests/test_stream_spans.py [-m gpu]
"""

import json
import math
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests.small import run_small

# metric -> the span of ``AdaptationRunner.frame_phases`` it reads
SPANS = {"adapt_step.forward_ms": "step.forward",
         "adapt_step.backward_ms": "step.backward",
         "adapt_step.eval_ms": "step.eval",
         "adapt_step.update_ms": "step.update",
         "stream.assemble_ms": "batch.assemble",
         "stream.upload_ms": "batch.upload"}


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_reader_means_its_span(metric):
    read = run.reader(metric)
    assert read({}) is None
    assert read({"frame_phases": {"step": [1.0]}}) is None
    record = {"frame_phases": {SPANS[metric]: [0.010, 0.020, 0.030],
                               "step": [9.0, 9.0, 9.0]}}
    assert read(record) == pytest.approx(20.0)


def test_small_stream_reports_the_spans():
    _, record = run_small("kitti360.stream", seconds=1.0)
    values = {m: run.reader(m)(record) for m in SPANS}
    assert all(v is not None and math.isfinite(v) and v > 0
               for v in values.values()), values
    parts = sum(values[m] for m in SPANS if m.startswith("adapt_step."))
    assert parts <= run.reader("adapt_step.host_ms")(record)
    phases = record["frame_phases"]
    batch_ms = sum(phases["batch"]) / len(phases["batch"]) * 1e3
    assert values["stream.assemble_ms"] + values["stream.upload_ms"] \
        <= batch_ms


@pytest.mark.gpu
def test_traced_stream_reports_the_spans_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "kitti360.stream", "--seed", "3000000998", "--seconds", "3",
         "--trace", "1"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    for metric in SPANS:
        assert math.isfinite(result["metrics"][metric]["value"]), metric
