"""The host's CPU clocks over a window: the process's CPU time (user and
system), each thread's, its page faults and context switches, the time
in the interpreter's garbage collector, and the machine's (``/proc/stat``:
user, system, idle, steal), so that a run can say whether its host was
slow or busy or its process did more."""

from __future__ import annotations

import gc
import os
import resource
import threading
import time

_GC = {"s": 0.0, "runs": [0, 0, 0], "t0": None}


def _gc_clock(phase, info):
    if phase == "start":
        _GC["t0"] = time.perf_counter()
    elif _GC["t0"] is not None:
        _GC["s"] += time.perf_counter() - _GC["t0"]
        _GC["runs"][info["generation"]] += 1
        _GC["t0"] = None


_TICK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
_STAT_FIELDS = ("user", "nice", "system", "idle", "iowait", "irq",
                "softirq", "steal")


def _thread_ticks():
    """{native thread id: utime + stime ticks} of this process."""
    out = {}
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/self/task/{tid}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        out[int(tid)] = int(fields[11]) + int(fields[12])
    return out


def _machine_ticks():
    try:
        with open("/proc/stat") as fh:
            parts = fh.readline().split()[1:1 + len(_STAT_FIELDS)]
    except OSError:
        return {}
    return dict(zip(_STAT_FIELDS, map(int, parts)))


def snapshot():
    """The clocks now (the first call starts the collector's clock)."""
    if _gc_clock not in gc.callbacks:
        gc.callbacks.append(_gc_clock)
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"process_s": time.process_time(), "wall_s": time.perf_counter(),
            "threads": _thread_ticks(), "machine": _machine_ticks(),
            "rusage": {"user_s": ru.ru_utime, "system_s": ru.ru_stime,
                       "minor_faults": ru.ru_minflt,
                       "major_faults": ru.ru_majflt,
                       "voluntary_switches": ru.ru_nvcsw,
                       "forced_switches": ru.ru_nivcsw},
            "gc": {"s": _GC["s"], "runs": list(_GC["runs"])}}


def between(a, b):
    """What the clocks read from snapshot ``a`` to snapshot ``b``: the
    process's CPU seconds, the busiest threads' (named where Python
    knows them), and the machine's shares of its ticks."""
    names = {t.native_id: t.name for t in threading.enumerate()}
    threads = sorted(((b["threads"][k] - a["threads"].get(k, 0)) / _TICK,
                      names.get(k, str(k)))
                     for k in b["threads"])[::-1]
    dm = {k: b["machine"].get(k, 0) - a["machine"].get(k, 0)
          for k in b["machine"]}
    total = sum(dm.values()) or 1
    return {"process_cpu_s": b["process_s"] - a["process_s"],
            "wall_s": b["wall_s"] - a["wall_s"],
            "threads_cpu_s": [(n, s) for s, n in threads[:4] if s > 0],
            "rusage": {k: b["rusage"][k] - a["rusage"][k]
                       for k in b["rusage"]},
            "gc_s": b["gc"]["s"] - a["gc"]["s"],
            "gc_runs": [y - x for x, y in zip(a["gc"]["runs"],
                                              b["gc"]["runs"])],
            "machine_pct": {k: round(100.0 * v / total, 2)
                            for k, v in dm.items()},
            "cores": os.cpu_count(),
            "usable_cores": (len(os.sched_getaffinity(0))
                             if hasattr(os, "sched_getaffinity") else None)}
