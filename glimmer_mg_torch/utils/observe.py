"""Observability: stage timers, throughput counters, profiler hooks.

Replaces the reference's ad-hoc instrumentation (SURVEY §5):
  - wall-clock stamps to stderr       (glimmer3.cc:172-173)
  - ``--time`` per-stage files        (scripts/glimmer-mg.py:43-47,89-92,133-136)
  - ``Sequence_Log`` stage logging    (glimmer-mg.cc:422-442)
  - Phymm progress log                (scripts/scoreReadsGlim.pl:417-545)
  - global ``Verbose`` level          (src/Common/delcher.hh:63)

Design: a :class:`StageTimers` object is threaded through pipeline entry
points. Each stage is a context manager that records wall-clock and optional
work counters (reads, bp), from which reads/s and Mbp/s throughputs are
derived — the BASELINE metrics. ``write_time_files`` emits the reference's
``time_<out>_<stage>.txt`` format (one ``%.3fs`` line per file) so tooling
that consumed the reference's --time output keeps working. ``profiler_trace``
wraps ``torch.profiler`` for on-demand host and CUDA traces.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field

#: Global verbosity level (reference ``Verbose``, delcher.hh:63).
#: 0 = quiet, 1 = stage lines, 2+ = debug detail.
VERBOSE = 0


def set_verbose(level: int) -> None:
    global VERBOSE
    VERBOSE = int(level)


def vlog(level: int, msg: str) -> None:
    """Print ``msg`` to stderr when VERBOSE >= level."""
    if VERBOSE >= level:
        print(msg, file=sys.stderr, flush=True)


@dataclass
class Stage:
    name: str
    wall_s: float = 0.0
    items: int = 0          # e.g. reads processed
    bp: int = 0             # base pairs processed
    meta: dict = field(default_factory=dict)

    @property
    def items_per_s(self) -> float:
        return self.items / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def mbp_per_s(self) -> float:
        return self.bp / 1e6 / self.wall_s if self.wall_s > 0 else 0.0


class StageTimers:
    """Per-stage wall-clock + throughput counters for one pipeline run."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stages: list[Stage] = []
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str, log: bool = True):
        """Time a named stage. Yields a Stage whose ``items``/``bp``
        counters the caller may fill in for throughput reporting."""
        st = Stage(name)
        if not self.enabled:
            yield st
            return
        if log:
            vlog(1, f"[stage] {name} ...")
        t0 = time.perf_counter()
        try:
            yield st
        finally:
            st.wall_s = time.perf_counter() - t0
            self.stages.append(st)
            if log:
                vlog(1, f"[stage] {name}: {self.format_stage(st)}")

    @property
    def total_s(self) -> float:
        return time.perf_counter() - self._t0

    @staticmethod
    def format_stage(st: Stage) -> str:
        parts = [f"{st.wall_s:.3f}s"]
        if st.items:
            parts.append(f"{st.items} items, {st.items_per_s:.1f}/s")
        if st.bp:
            parts.append(f"{st.bp/1e6:.3f} Mbp, {st.mbp_per_s:.2f} Mbp/s")
        for k, v in st.meta.items():
            parts.append(f"{k}={v}")
        return ", ".join(parts)

    def report(self) -> str:
        """Multi-line human-readable per-stage summary."""
        lines = ["stage timings:"]
        for st in self.stages:
            lines.append(f"  {st.name:<24s} {self.format_stage(st)}")
        lines.append(f"  {'TOTAL':<24s} {self.total_s:.3f}s")
        return "\n".join(lines)

    def write_time_files(self, out_prefix: str, workdir: str = ".") -> None:
        """Reference --time format: ``time_<out>_<stage>.txt`` per stage plus
        ``time_<out>.txt`` total, each one '%.3fs' line
        (scripts/glimmer-mg.py:43-47,133-136)."""
        for st in self.stages:
            path = os.path.join(workdir, f"time_{out_prefix}_{st.name}.txt")
            with open(path, "w") as fh:
                fh.write("%.3fs\n" % st.wall_s)
        with open(os.path.join(workdir, f"time_{out_prefix}.txt"), "w") as fh:
            fh.write("%.3fs\n" % self.total_s)


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Optionally wrap a block in ``torch.profiler`` (host ops, and CUDA
    kernels when a GPU is present) and write its Chrome trace,
    ``<host>_<pid>.<time>.pt.trace.json``, into ``log_dir``. No-op when
    ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield

class ProgressLog:
    """Phymm-style progress file, updated every ``every`` units
    (scoreReadsGlim.pl:417-545 writes ``*_progress.txt`` every 50 ICMs)."""

    def __init__(self, path: str | None, total: int, every: int = 50):
        self.path = path
        self.total = total
        self.every = every
        self.done = 0

    def advance(self, n: int = 1) -> None:
        prev = self.done
        self.done += n
        if self.path and (self.done // self.every != prev // self.every
                          or self.done >= self.total):
            with open(self.path, "w") as fh:
                fh.write(f"{self.done}/{self.total}\n")
