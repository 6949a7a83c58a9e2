"""Readings that set a cell's limits, on the card at the cell's own size:

    python3 -m benchmark.control --workload <cell> --variant <v> \
        --seeds <n> [<n> ...]

``--variant program``: the port as the benchmark runs it (the lower
readings); ``fp8``: the control, the plain reference in emulated float8 put
in the program's place; ``half_batch``: the reference in float32 in the
program's place, half of each batch left out; ``bf16_loss`` (the stream):
the reference in float32 in the program's place with its losses'
arithmetic in bfloat16, as the port's bfloat16 configuration computes
them, a witness of what that arithmetic alone moves. Each seed runs the cell's
set-up and its checked steps (the check needs no measured window) and
prints one JSON line of the numbers the check compares, each seed in a
process of its own (as the benchmark runs them: a loader thread of one
seed never draws into the next). The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time

VARIANTS = {"program": None, "fp8": ("fp8", None),
            "half_batch": ("float32", "half_batch"),
            "bf16_loss": ("float32", None, "bfloat16")}


def readings(cell_name, variant, seeds, device, cell=None):
    """{seed: numbers} of ``variant`` on ``seeds``."""
    from benchmark import configs
    cell = cell or configs.cell(cell_name)
    driver = importlib.import_module(
        f"benchmark.drivers.{cell['traffic']['driver']}")
    out = {}
    for seed in seeds:
        record = driver.run(cell, seed, 0, False, device, time.perf_counter,
                            control=VARIANTS[variant])
        out[seed] = dict(record["numbers"],
                         readings=record.get("notes", {}).get("readings"))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--variant", choices=sorted(VARIANTS),
                        required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    if len(args.seeds) > 1:
        for seed in args.seeds:
            subprocess.run([sys.executable, "-m", "benchmark.control",
                            "--workload", args.workload, "--variant",
                            args.variant, "--seeds", str(seed)], check=False)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        numbers = readings(args.workload, args.variant, [seed], device)
        print(json.dumps({"workload": args.workload,
                          "variant": args.variant, "seed": seed,
                          "numbers": numbers[seed]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
