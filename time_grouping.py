"""Time the pixel-grouping kernel at fixed valid-center counts, beside
other builds of the same C interface, in turns on one card.

    python3 time_grouping.py [--against SOURCE:LAYOUT ...] [--sass DIR]

The inputs are ``chip_smoke.fixed_grouping_inputs``: 1x384x1408 offsets
~ N(0, 20) px drawn from the seed and passed as the NHWC view of an NCHW
tensor, K = 200 center slots of which the first n are valid, n in
``chip_smoke.VALID_COUNTS``; so the numbers do not depend on any weights.

``codeps_torch/csrc/grouping.cu`` and every ``--against`` source (a
``.cu`` file with the same ``extern "C" group_pixels_launch``) are
compiled with the flags of ``codeps_torch/ops/_build.py`` plus
``-Xptxas -v`` (printed: registers, shared memory, spills) and launched
through ctypes. LAYOUT is how a source reads the offsets: ``planes``,
(B, 2, H, W), or ``pairs``, (B, H, W, 2) interleaved; a ``pairs`` source
is handed a contiguous NHWC copy made beforehand. Every output must
equal ``group_pixels_plain``. At each n the builds are timed in turns,
the repository's in the middle (a, b, ours, ours, b, a), each with
``chip_smoke.device_ms`` over 100 launches. Also timed once: the
``.contiguous()`` copy of the NHWC view (what the wrapper did before it
read the planes in place) and an empty queued launch
(``torch.cuda._sleep(0)``), the floor of any kernel timed this way.

``--sass DIR`` writes each build's SASS (``cuobjdump -sass``) to DIR and
counts the instructions of its distance loop: in each kernel, the body of
the backward branch densest in FMUL (two FMUL per (pixel, center) pair),
by opcode and per pair.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
OURS = REPO / "codeps_torch" / "csrc" / "grouping.cu"
ITERS = 100


def build_all(sources, out_dir):
    """{source: (library, ptxas report)}, one nvcc per source, all
    started together."""
    from codeps_torch.ops import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = (*_build.NVCC_FLAGS, "-Xptxas", "-v")
    jobs = {}
    for source in sources:
        digest = hashlib.sha256(source.read_bytes()
                                + " ".join(flags).encode()).hexdigest()
        lib = out_dir / f"lib{source.stem}-{digest[:16]}.so"
        jobs[source] = (lib, subprocess.Popen(
            [_build._nvcc(), *flags, "-o", str(lib), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for source, (lib, proc) in jobs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{report}")
        built[source] = (lib, report)
    return built


def launcher(lib):
    fn = ctypes.CDLL(str(lib)).group_pixels_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _opcode(instruction):
    """``FSETP`` of ``@!P0 FSETP.GEU.AND P1, PT, R2, R3, PT``."""
    return re.sub(r"^@!?U?P\w+\s+", "", instruction).split()[0] \
        .split(".")[0]


def loop_counts(sass):
    """{kernel: (instructions, pairs, opcode counts)} of each kernel's
    distance loop in ``cuobjdump -sass`` output."""
    kernels = {}
    name, lines = None, []
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            if name:
                kernels[name] = lines
            name, lines = head.group(1), []
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if name and ins:
            lines.append((int(ins.group(1), 16), ins.group(2)))
    if name:
        kernels[name] = lines
    result = {}
    for name, lines in kernels.items():
        best = None
        for at, text in lines:
            target = re.findall(r"0x([0-9a-f]+)", text)
            if _opcode(text) != "BRA" or not target \
                    or int(target[-1], 16) >= at:
                continue
            start = int(target[-1], 16)
            body = [t for a, t in lines if start <= a <= at]
            ops = collections.Counter(_opcode(t) for t in body)
            density = ops["FMUL"] / len(body)
            if ops["FMUL"] and (best is None or density > best[0]):
                best = (density, (len(body), ops["FMUL"] // 2, dict(ops)))
        if best:
            result[name] = best[1]
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--against", action="append", default=[],
                        metavar="SOURCE:LAYOUT")
    parser.add_argument("--sass", type=Path, default=None, metavar="DIR")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_grouping: CUDA is not available; this script runs on "
              "a machine with a card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from codeps_torch.ops.grouping import group_pixels_plain, offset_planes

    others = []
    for spec in args.against:
        path, _, layout = spec.rpartition(":")
        if layout not in ("planes", "pairs"):
            parser.error(f"LAYOUT of {spec} must be planes or pairs")
        others.append((Path(path).resolve(), layout))
    builds = [(OURS, "planes")] + others
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    built = build_all([path for path, _ in builds],
                      REPO / "codeps_torch" / "_build" / "timing")
    names = {}
    for path, _ in builds:
        names[path] = (path.stem if path != OURS
                       else "grouping (this tree)")
        lib, report = built[path]
        print(f"== {names[path]}: {path}\n{report.strip()}")
    if args.sass:
        args.sass.mkdir(parents=True, exist_ok=True)
        from codeps_torch.ops import _build
        cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
        for path, _ in builds:
            lib = built[path][0]
            sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                                  capture_output=True, text=True,
                                  check=True).stdout
            (args.sass / f"{lib.stem}.sass").write_text(sass)
            for kernel, (count, pairs, ops) in loop_counts(sass).items():
                print(f"SASS {names[path]} {kernel}: distance loop "
                      f"{count} instructions for {pairs} pairs, "
                      f"{count / pairs:.2f} a pair; {ops}")

    launch = {path: launcher(built[path][0]) for path, _ in builds}
    stream = torch.cuda.current_stream().cuda_stream
    results = {"card": smi, "by_valid_centers": []}
    order = others + [builds[0]] * 2 + others[::-1]  # a, b, ours, ours, b, a
    for n in smoke.VALID_COUNTS:
        yx, valid, view = smoke.fixed_grouping_inputs(torch, device, n)
        ref = group_pixels_plain(yx, valid, view)
        src = {"planes": offset_planes(view), "pairs": view.contiguous()}
        out = torch.empty(ref.shape, dtype=torch.int32, device=device)
        times = collections.defaultdict(list)
        for path, layout in order:
            def run(fn=launch[path], offsets=src[layout]):
                err = fn(yx.data_ptr(), valid.data_ptr(),
                         offsets.data_ptr(), out.data_ptr(), 1,
                         yx.shape[1], view.shape[1], view.shape[2], stream)
                assert err == 0, err
            out.fill_(-1)
            run()
            torch.cuda.synchronize()
            assert torch.equal(out, ref), f"{names[path]} != plain at n={n}"
            times[path].append(smoke.device_ms(torch, run, iters=ITERS))
        bound_ms, bound_by, _, _ = smoke.grouping_bound(n)
        row = {"valid_centers": n, "bound_ms": bound_ms,
               "bound_by": bound_by,
               "ms": {names[p]: times[p] for p, _ in builds}}
        results["by_valid_centers"].append(row)
        print(f"n = {n}: bound {bound_ms * 1e3:.3f} us ({bound_by}); "
              + "; ".join(f"{names[p]} " + ", ".join(
                  f"{t * 1e3:.3f}" for t in times[p]) + " us"
                  for p, _ in builds))

    yx, valid, view = smoke.fixed_grouping_inputs(torch, device, 0)
    copy_ms = smoke.device_ms(torch, view.contiguous, iters=ITERS)
    moved = 2 * view.numel() * 4
    print(f"NHWC copy of the (1, 2, {view.shape[1]}, {view.shape[2]}) "
          f"view (.contiguous()): {copy_ms * 1e3:.3f} us; bound "
          f"{moved / smoke.HBM_BYTES_PER_S * 1e6:.3f} us ({moved} B)")
    empty_ms = smoke.device_ms(torch, lambda: torch.cuda._sleep(0),
                               iters=ITERS)
    print(f"empty queued launch: {empty_ms * 1e3:.3f} us")
    results.update(copy_ms=copy_ms, empty_launch_ms=empty_ms)
    print(json.dumps({"time_grouping": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
