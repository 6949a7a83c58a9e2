"""A steady host for a run: fixed thread counts and fixed cores.

A stream frame's pace is set on the host: the main thread assembles the
batch and dispatches the step while the prefetch thread and its
preprocessing pool make the next sample. Left to themselves, the math
libraries start a thread per core and the scheduler moves the main
thread among cores that those threads and the pool keep busy, so the same
seed reads differently from run to run.

``limit_threads`` runs before numpy or torch is imported: every math
library's pool has ``THREADS`` threads, torch's inter-op pool one.
``pin_threads`` runs once the run's threads exist: the main thread gets
one physical core of its own (its hyperthread siblings with it), every
other thread of the process, and those they start later, the remaining
cores. Both act on this process alone.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

THREADS = 4
THREAD_VARIABLES = ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                    "OPENBLAS_NUM_THREADS", "NUMEXPR_NUM_THREADS")


def limit_threads() -> None:
    """Fix the math libraries' pools at ``THREADS`` threads (call before
    numpy or torch is imported; torch is set again once it is)."""
    for name in THREAD_VARIABLES:
        os.environ[name] = str(THREADS)


def limit_torch_threads(torch) -> None:
    torch.set_num_threads(THREADS)
    try:
        torch.set_num_interop_threads(1)
    except RuntimeError:  # the pool has already started
        pass


def _core_of(cpu: int):
    topology = Path(f"/sys/devices/system/cpu/cpu{cpu}/topology")
    try:
        return ((topology / "physical_package_id").read_text().strip(),
                (topology / "core_id").read_text().strip())
    except OSError:
        return ("", str(cpu))


def split_cores(cpus=None):
    """(the main thread's CPUs, the other threads' CPUs): the lowest
    physical core's CPUs and the rest; ``None`` where fewer than two
    physical cores are allowed."""
    cpus = sorted(os.sched_getaffinity(0) if cpus is None else cpus)
    cores = {}
    for cpu in cpus:
        cores.setdefault(_core_of(cpu), []).append(cpu)
    if len(cores) < 2:
        return None
    first = min(cores.values(), key=min)
    return set(first), set(cpus) - set(first)


def pin_threads() -> dict:
    """Pin the calling (main) thread to its core and every other thread of
    the process to the rest; returns what was set, for the run's notes."""
    split = split_cores()
    if split is None:
        return {"pinned": False, "cpus": sorted(os.sched_getaffinity(0))}
    main, others = split
    me = threading.get_native_id()
    for task in os.listdir("/proc/self/task"):
        tid = int(task)
        if tid == me:
            continue
        try:
            os.sched_setaffinity(tid, others)
        except OSError:  # the thread ended meanwhile
            pass
    os.sched_setaffinity(me, main)
    return {"pinned": True, "main": sorted(main), "others": sorted(others),
            "threads": len(os.listdir("/proc/self/task"))}
