"""Observability: stage timers, a span-and-counter recorder, throughput
counters, profiler hooks.

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

The recorder is one per process. ``with span(name, **attrs):`` records, on
any thread, the span's name, the thread's native id, its start and end on
``time.perf_counter_ns``, the thread's CPU time inside it
(``time.thread_time_ns``) and small integer attributes; ``span(...).part(p)``
times pieces of a span that are summed into one record, ``<name>.<p>``.
``count(name, n)`` adds to a named counter. ``snapshot()`` returns the
spans and counters, with the route counters (``engine.glimmer_mg``) and
the kernel launch counters (``ops.*_cuda``) of the loaded modules folded
in. Stages of :class:`StageTimers` are spans ``stage.<name>``. Only
``enable()`` and the CLI's ``--profile DIR`` (``profiler_trace``) turn the
recorder on; ``disable()`` turns it off and ``reset()`` empties it. Off,
a span costs one test of a module-level flag and returns a shared no-op
context (no record and no profiler call), and a count one flag test. On,
a span costs a clock read and a thread-CPU read at each end and one
record (PERF.md §6 gives the measured cost).
``profiler_trace`` appends the spans of every thread to the Chrome trace
it writes, as ``cat: "program_span"`` events on the trace's clock (an
:class:`Anchor` annotation, whose host times are taken where the profiler
stamps it, maps one clock onto the other: ``trace_events``), and the
counters under ``programSpans``.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

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


# -- the recorder ------------------------------------------------------------

_ON = False
_SPANS: list = []  # SpanRecord, in the order the spans closed
_COUNTERS: dict = {}
_THREADS: dict = {}  # native thread id -> thread name
_LOCK = threading.Lock()

_PKG = __name__.split(".")[0]
# counters the port keeps whether the recorder is on or not, by the name
# snapshot() gives them: (module, attribute, name)
_FOLDED = (("ops.icm_cuda", "launches", "six_frame_launches"),
           ("ops.icm_cuda", "bank_walk_launches", "bank_walk_launches"),
           ("ops.icm_cuda", "bank_walk_int8_launches",
            "bank_walk_int8_launches"),
           ("ops.frontend_cuda", "launches", "frontend_launches"),
           ("ops.event_dp_cuda", "launches", "event_dp_launches"),
           ("ops.raw_text_cuda", "launches", "raw_text_launches"))


class SpanRecord(NamedTuple):
    name: str
    tid: int  # the thread's native id, as the profiler's trace gives it
    t0: int  # time.perf_counter_ns at the start
    t1: int  # ... and at the end
    wall: int  # ns inside the span: t1 - t0, or a part's summed pieces
    cpu: int  # the thread's CPU ns inside it
    attrs: dict


def enable() -> None:
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def enabled() -> bool:
    return _ON


def reset() -> None:
    """Forget every span and counter recorded so far."""
    with _LOCK:
        _SPANS.clear()
        _COUNTERS.clear()


class _Off:
    """The span, and each of its parts, while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass

    def part(self, name):
        return self


_OFF = _Off()


class _Part:
    """Pieces of a span, entered and left many times, summed."""

    __slots__ = ("wall", "cpu", "_t", "_c")

    def __init__(self):
        self.wall = self.cpu = 0

    def __enter__(self):
        self._c = time.thread_time_ns()
        self._t = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.wall += time.perf_counter_ns() - self._t
        self.cpu += time.thread_time_ns() - self._c
        return False


class _Span:
    __slots__ = ("name", "attrs", "parts", "_t", "_c")

    def __init__(self, name, attrs):
        self.name, self.attrs, self.parts = name, attrs, {}

    def __enter__(self):
        self._c = time.thread_time_ns()
        self._t = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        cpu = time.thread_time_ns() - self._c
        tid = threading.get_native_id()
        if tid not in _THREADS:
            _THREADS[tid] = threading.current_thread().name
        # list.append is atomic: spans close on any thread without a lock
        _SPANS.append(SpanRecord(self.name, tid, self._t, t1, t1 - self._t,
                                 cpu, self.attrs))
        for p, acc in self.parts.items():
            _SPANS.append(SpanRecord(f"{self.name}.{p}", tid, self._t, t1,
                                     acc.wall, acc.cpu, {}))
        return False

    def set(self, **attrs):
        """Attributes known only inside the span (bytes, rows)."""
        self.attrs.update(attrs)

    def part(self, name):
        """A context for the pieces of this span that make its part
        ``name``: their time is summed and recorded, when the span closes,
        as one record ``<span>.<name>`` over the span's interval."""
        return self.parts.setdefault(name, _Part())


def span(name: str, **attrs):
    """A context that records the span ``name`` (``layer.part``) with
    integer ``attrs``, or a shared no-op one while the recorder is off."""
    if not _ON:
        return _OFF
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the recorder is on."""
    if not _ON:
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def snapshot() -> dict:
    """{"spans": [SpanRecord], "counters": {name: n}, "threads": {native id:
    name}}. The counters hold the recorder's and, from the port's modules
    that are loaded, the route counters (``device_reads`` ...) and kernel
    launches (``_FOLDED``), which count whether the recorder is on or not;
    their readers' names stay where they are."""
    with _LOCK:
        counters = dict(_COUNTERS)
    for mod, attr, name in _FOLDED:
        m = sys.modules.get(f"{_PKG}.{mod}")
        if m is not None:
            counters[name] = getattr(m, attr)
    eng = sys.modules.get(f"{_PKG}.engine.glimmer_mg")
    if eng is not None:
        counters.update(eng.counters)
    return {"spans": list(_SPANS), "counters": counters,
            "threads": dict(_THREADS)}


class Anchor:
    """A ``torch.profiler`` annotation whose host times are known, the
    point both clocks see: ``t_open`` and ``t_close`` (``perf_counter_ns``)
    are taken right before it opens and right before it closes. The
    profiler stamps inside those calls, and they let go of the interpreter
    lock: a stamp taken after one would wait to get the lock back (up to
    the switch interval, 5 ms, while another thread runs Python), and a
    process's first annotation sets up after the profiler's stamp.
    ``trace_events`` reports what is left as the residual."""

    def __init__(self, name: str):
        self.name = name
        self.t_open = self.t_close = None

    def __enter__(self):
        import torch

        self._rf = torch.profiler.record_function(self.name)
        self.t_open = time.perf_counter_ns()
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.t_close = time.perf_counter_ns()
        self._rf.__exit__(*exc)
        return False


def trace_events(rec: dict, anchor: Anchor, events: list):
    """The spans of ``rec`` (a ``snapshot()``) that overlap ``anchor`` as
    Chrome trace events (``cat: "program_span"``, one row a thread) on the
    clock of the trace ``events``, which hold the anchor's annotation; and
    the residual in microseconds, the mapped close of the anchor less its
    close in the trace (the mapping is exact at the open)."""
    ann = next(e for e in events
               if e.get("name") == anchor.name and e.get("ph") == "X")
    off = float(ann["ts"]) - anchor.t_open / 1e3
    residual = (anchor.t_close / 1e3 + off
                - (float(ann["ts"]) + float(ann["dur"])))
    pid = ann.get("pid", os.getpid())
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": name}}
           for tid, name in rec["threads"].items()]
    out += [{"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
             "tid": s.tid, "ts": s.t0 / 1e3 + off, "dur": (s.t1 - s.t0) / 1e3,
             "args": {"wall_us": s.wall / 1e3, "cpu_us": s.cpu / 1e3,
                      **s.attrs}}
            for s in rec["spans"]
            if s.t1 >= anchor.t_open and s.t0 <= anchor.t_close]
    return out, residual


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

    def __init__(self):
        self.stages: list[Stage] = []
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str, log: bool = True):
        """Time a named stage, also a span ``stage.<name>`` of the
        recorder. Yields a Stage whose ``items``/``bp`` counters the caller
        may fill in for throughput reporting."""
        st = Stage(name)
        if log:
            vlog(1, f"[stage] {name} ...")
        with span("stage." + name) as sp:
            t0 = time.perf_counter()
            try:
                yield st
            finally:
                st.wall_s = time.perf_counter() - t0
                sp.set(items=st.items, bp=st.bp)
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


#: The annotation that anchors a ``profiler_trace``'s program spans.
PROFILE_ANCHOR = "glimmer_mg.profile"


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Optionally wrap a block in ``torch.profiler`` (host ops, and CUDA
    kernels when a GPU is present) with the recorder on, and write its
    Chrome trace, ``<host>_<pid>.<time>.pt.trace.json``, into ``log_dir``:
    the profiler's events, then the program's spans from every thread
    (``trace_events``; the worker thread's reach the trace only this way)
    and ``programSpans``: the anchor's name, its residual in microseconds
    and the counters of ``snapshot()``. No-op when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    anchor = Anchor(PROFILE_ANCHOR)

    def write(prof):
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}"
                            f".{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
        rec = snapshot()
        extra, residual = trace_events(rec, anchor, trace["traceEvents"])
        trace["traceEvents"] += extra
        trace["programSpans"] = {"anchor": PROFILE_ANCHOR,
                                 "residual_us": residual,
                                 "counters": rec["counters"]}
        with open(path, "w") as fh:
            json.dump(trace, fh)

    was_on = _ON
    enable()
    try:
        with profile(activities=acts, on_trace_ready=write), anchor:
            yield
    finally:
        if not was_on:
            disable()


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
