"""The traced run's device trace: ``torch.profiler`` (CUPTI) around the
window, its Chrome trace read back.

Device activity is every kernel, copy and set on the device whose launch
(the runtime call with the same correlation id) falls inside the window's
annotation; busy time is their union inside the window. Kernels are
named by the sources' ``__global__`` names. The device's idle gaps are
labelled by the program's whole spans (``lib/program.py``) open at each
gap's middle, mapped onto the trace's clock by the program's anchor.
"""

from __future__ import annotations

import collections
import json
import os
import re

WINDOW = "bench_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the hand-written kernels: K1 csrc/six_frame.cu, KF csrc/frontend.cu,
# K3 csrc/event_dp.cu, K2 csrc/bank_walk.cu (three kernels a launch), KT
# csrc/raw_text.cu (four kernels a launch)
KERNELS = {"k1": re.compile(r"\bsix_frame_kernel\b"),
           "kf": re.compile(r"\bfrontend_kernel\b"),
           "k3": re.compile(r"\bevent_dp_kernel\b"),
           "k2": re.compile(r"\b(prep|walk|finish)_kernel\b"),
           "kt": re.compile(r"\b(measure|rows|place|write)_kernel\b")}
OUTSIDE = "outside the program's spans"


def short(name):
    """A kernel's name without namespaces, template arguments and
    parameters."""
    n = re.sub(r"\(.*$", "", name)
    depth, out = 0, []
    for ch in n:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    n = "".join(out).split("::")[-1].replace("void ", "").strip()
    return n[:64] or name[:64]


def _union(iv):
    total, cur_s, cur_e, merged = 0.0, None, None, []
    for s, e in sorted(iv):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                merged.append((cur_s, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        merged.append((cur_s, cur_e))
    for s, e in merged:
        total += e - s
    return total, merged


class DeviceTrace:
    """What the metrics read of the device trace (seconds)."""

    def __init__(self, events, program_spans=lambda events: []):
        """``program_spans(events)``: the program's whole spans as Chrome
        trace events on the clock of ``events``."""
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("ph") == "X"]
        if not win:
            raise RuntimeError("the trace has no window annotation")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        launch_ts = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    launch_ts[c] = float(e["ts"])

        def in_window(e):
            c = (e.get("args") or {}).get("correlation")
            t = launch_ts.get(c, float(e["ts"]))
            return w0 <= t <= w1

        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and e.get("ph") == "X" and in_window(e)]
        self.device_events = len(dev)
        iv = [(max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"])))
              for e in dev]
        busy, merged = _union([(s, t) for s, t in iv if t > s])
        self.busy_s = busy * 1e-6
        self.kernel_s = {k: [] for k in KERNELS}
        by_name = collections.defaultdict(float)
        for e in dev:
            d = float(e["dur"]) * 1e-6
            by_name[short(e["name"])] += d
            if e.get("cat") == "kernel":
                for k, rx in KERNELS.items():
                    if rx.search(e["name"]):
                        self.kernel_s[k].append(d)
        self.top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        # idle gaps, by the innermost program span each thread has open at
        # each gap's middle
        spans = [(e["name"], e["tid"], float(e["ts"]),
                  float(e["ts"]) + float(e["dur"]))
                 for e in program_spans(events)]
        gaps = collections.defaultdict(float)
        edges = [w0] + [x for s, e in merged for x in (s, e)] + [w1]
        mids = sorted((0.5 * (s + e), (e - s) * 1e-6)
                      for s, e in zip(edges[0::2], edges[1::2]) if e > s)
        # (time, 0 opens / 1 closes, span): a span opens before it closes
        marks = sorted([(a, 0, k) for k, (_n, _t, a, _b) in enumerate(spans)]
                       + [(b, 1, k) for k, (_n, _t, _a, b)
                          in enumerate(spans)])
        open_, k = set(), 0
        for mid, secs in mids:  # one sweep over the spans' edges
            while k < len(marks) and marks[k][0] <= mid:
                (open_.discard if marks[k][1] else open_.add)(marks[k][2])
                k += 1
            inner = {}
            for j in open_:
                name, tid, a, _b = spans[j]
                if tid not in inner or a > inner[tid][0]:
                    inner[tid] = (a, name)
            label = "+".join(sorted(n for _a, n in inner.values()))
            gaps[label or OUTSIDE] += secs
        self.idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]


def read(prof, tmp_dir, program_spans=lambda events: []) -> DeviceTrace:
    path = os.path.join(tmp_dir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as fh:
            data = json.load(fh)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return DeviceTrace(events, program_spans)
