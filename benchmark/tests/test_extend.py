"""A cell, a configuration, a traffic mix and a per-layer metric added as
new files are picked up by name, with no file of the benchmark edited but
the listing in BENCHMARK.json."""

import json
import shutil
import subprocess
import sys

from benchmark import run

PROBE = """
import json
from benchmark import configs, run
bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
cell = configs.cell("newcfg.newmix")
names = [m["name"] for m in run.cell_metrics(bench, "newcfg.newmix", True)]
print(json.dumps({"config": cell["config"]["name"],
                  "driver": cell["traffic"]["driver"],
                  "metrics": names,
                  "value": run.reader("new.metric_ms")({"x": 2.5})}))
"""


def test_new_files_are_found(tmp_path):
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    bench_dir = tmp_path / "benchmark"
    config = json.loads((bench_dir / "configs" /
                         "adapt_kitti360_r101.json").read_text())
    (bench_dir / "configs" / "newcfg.json").write_text(json.dumps(config))
    (bench_dir / "traffic" / "newmix.json").write_text(json.dumps(
        {"driver": "stream", "stream_frames": 10, "replay_prefill": 5,
         "source_images": 5, "checked_frames": 3, "profiled_frames": 3}))
    (bench_dir / "workloads" / "newcfg.newmix.json").write_text(json.dumps(
        {"config": "newcfg", "traffic": "newmix", "limits": {}}))
    (bench_dir / "metrics" / "new.metric_ms.py").write_text(
        "def read(record):\n    return record.get('x')\n")
    listing = json.loads((tmp_path / "BENCHMARK.json").read_text())
    listing["configs"].append({"name": "newcfg", "source": "x",
                               "file": "benchmark/configs/newcfg.json",
                               "reduced": [], "why": "x"})
    listing["workloads"].append({"name": "newcfg.newmix",
                                 "config": "newcfg", "traffic": "newmix",
                                 "chips": 1, "why": "x"})
    listing["per_layer"].append({"name": "new.metric_ms", "unit": "ms",
                                 "better": "lower", "source": "host_clock",
                                 "layer": "x", "moves": "frames_per_s",
                                 "workloads": ["newcfg.newmix"]})
    listing["end_to_end"][0]["workloads"].append("newcfg.newmix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(listing))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"config": "newcfg", "driver": "stream",
                   "metrics": ["new.metric_ms"], "value": 2.5}
    for path, data in before.items():
        assert path.read_bytes() == data, path
