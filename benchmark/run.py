"""The benchmark of ``codeps_torch`` on one CUDA card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json``: the cell's file
(``benchmark/workloads/<cell>.json``) names its configuration and traffic,
the traffic its driver (``benchmark/drivers/<driver>.py``). The driver
sets up, warms up, measures for ``--seconds`` and checks what the timed
path produced against the plain reference (``benchmark/reference``). Each
metric of the cell is read by its own reader (``benchmark/metrics/
<metric>.py``): with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a run that also profiles a
few steady frames or steps after the window. The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared beside its limit); the checks are also
the last lines of standard error.

The host is held steady (``host.py``): fixed thread counts from the start,
and the main thread on a core of its own once the driver's threads run.

Without a CUDA card, with fewer cards than the cell asks for, or with JAX
or the JAX package loaded once the window has closed, it prints no result
and exits non-zero.
"""

import time

START = time.perf_counter()

from benchmark import host  # noqa: E402

host.limit_threads()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "codeps_tpu")
# build and kernel caches at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": ".bench_cache/triton",
          "TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions"}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def reader(name: str):
    """The ``read(record)`` of metric ``name``
    (``benchmark/metrics/<name>.py``)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell: str, traced: bool):
    """The metric entries the cell reports in this kind of run."""
    kind = "per_layer" if traced else "end_to_end"
    return [m for m in bench[kind]
            if cell in m.get("workloads", [w["name"]
                                           for w in bench["workloads"]])]


def loaded_forbidden():
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    args = parse_args(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    host.limit_torch_threads(torch)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from benchmark import common, configs, judge
    cell = configs.cell(args.workload)
    driver = importlib.import_module(
        f"benchmark.drivers.{cell['traffic']['driver']}")
    device = torch.device("cuda", 0)
    record = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                        device, time.perf_counter)
    record["setup_s"] = record["t0"] - START
    record["gpu"] = common.gpu_info()
    found = loaded_forbidden()
    if found:
        print(f"loaded once the window closed: {found}", file=sys.stderr)
        return 3

    notes = dict(record.get("notes", {}), rate=record.get("rate"),
                 flops_per_unit=record.get("flops_per_unit"))
    print("notes " + json.dumps(notes), file=sys.stderr)
    correct, checks = judge.verdict(record["numbers"], cell["limits"])
    metrics = {}
    for metric in cell_metrics(bench, args.workload, bool(args.trace)):
        value = reader(metric["name"])(record)
        if value is not None and math.isfinite(value):
            metrics[metric["name"]] = {"value": value,
                                       "unit": metric["unit"]}
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0),
                   "count": entry["chips"],
                   "memory_peak_bytes": record["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics,
              "device": device_info}
    if args.trace and "profile" in record:
        device_info["busy_s"] = record["profile"]["busy_s"]
        device_info["window_s"] = record["profile"]["window_s"]
        result["breakdown"] = record["profile"]["breakdown"]
    result["power_limit"] = record["gpu"].get("power_limit")
    result["checks"] = checks
    for name, check in checks.items():
        print(f"check {name}: {check['value']} (limit {check['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
