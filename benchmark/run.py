#!/usr/bin/env python3
"""Run one cell of the benchmark of glimmer_mg_torch once, on this
machine's GPU:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--control f32|int8]

Set-up (the program's import and kernel build, the database, the reads,
a warm-up of the cell's shapes, and the fill of a pipeline before its
first output) is timed as ``setup_s``; the window then drives the
program for at least ``--seconds`` and ends at the first output boundary
after it. With ``--trace 1`` the program's own recorder
(``glimmer_mg_torch.utils.observe``) runs from before set-up to the
window's end, the window runs under the device profiler and the
harness's launch wrappers, and the line carries the per-layer metrics;
untraced, the recorder stays off.
Once the window has closed the plain reference checks a seeded sample of
what the window produced; each number compared is printed beside its
limit, as the last lines of standard error and under "checks", the last
key of the result, which is the last line of standard output.
``--control`` runs the program's lower-precision path instead (the f32
carry for prediction, the 8-bit tables for classification), which the
limits must fail.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BANNED = ("jax", "jaxlib", "flax", "glimmer_mg_tpu")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def banned_modules():
    """Loaded modules whose top-level name is one the port may not use."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def cache_env(bench_dir):
    """The build and kernel caches, at fixed paths inside the checkout;
    returns the benchmark's cache directory."""
    cache_dir = os.path.join(bench_dir, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache_dir,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache_dir, "triton")
    return cache_dir


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("f32", "int8"), default=None)
    return p.parse_args(argv)


def main(argv=None, *, bench_dir=HERE, device="cuda", t_start=None):
    """One run; returns the exit code. ``device="cpu"`` (tests only) skips
    the look for a card and runs the program on the CPU."""
    args = parse(argv)
    t_start = T_START if t_start is None else t_start
    from benchmark.lib import spec

    cell = spec.cell(bench_dir, args.workload)
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        log(f"no CUDA device for {cell.name}: is_available "
            f"{torch.cuda.is_available()}, {torch.cuda.device_count()} "
            f"device(s), the cell needs {cell.chips}")
        return 2
    cache_dir = cache_env(bench_dir)
    tmp_dir = tempfile.mkdtemp(prefix="bench-")
    try:
        return _run(args, cell, bench_dir, device, t_start, cache_dir,
                    tmp_dir)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)


def _run(args, cell, bench_dir, device, t_start, cache_dir, tmp_dir):
    import torch

    from benchmark.lib import counts, cpu, program, spans as spans_mod, \
        spec, trace

    cuda = device == "cuda"
    ctx = SimpleNamespace(
        seed=args.seed, control=args.control, device=device,
        config=cell.config, traffic=cell.traffic,
        cache_dir=cache_dir, tmp_dir=tmp_dir, log=log,
        sync=torch.cuda.synchronize if cuda else (lambda: None))
    if cuda:
        log(f"card: {card_line()}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}")
    op = spec.load_module(cell.op_path, "bench_op").Op(ctx)
    observe = None
    if args.trace:  # the program's recorder, from before set-up
        from glimmer_mg_torch.utils import observe

        observe.reset()
        observe.enable()
    try:
        op.setup()
        ctx.sync()
        setup_s = time.perf_counter() - t_start
        log(f"set-up before the window's call {setup_s:.3f} s")

        rec = spans_mod.Recorder()
        if args.trace:
            for obj, attr, name, keep in op.spans():
                rec.wrap(obj, attr, name, keep)
        c0 = op.counters()
        at_close = {}
        stack = contextlib.ExitStack()
        prof = None
        if args.trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            rec.active = True

        def opened():
            at_close["c0"] = op.counters()
            at_close["cpu0"] = cpu.snapshot()
            if args.trace:
                at_close["anchor"] = stack.enter_context(
                    observe.Anchor(trace.WINDOW))
                rec.opened()

        def closed():
            stack.close()  # the window's anchor closes first
            if "counters" not in at_close:  # the first call, at the end
                at_close["cpu1"] = cpu.snapshot()
                at_close["counters"] = op.counters()
                rec.closed()

        try:
            w = op.window(args.seconds, opened, closed)
            ctx.sync()
        finally:
            closed()
            if prof is not None:
                prof.stop()
            rec.restore()
        snap = observe.snapshot() if args.trace else None
    finally:
        if observe is not None:
            observe.disable()
            observe.reset()
    # the time before the window opened (a pipeline's fill) is set-up
    setup_s += w.get("fill_s", 0.0)
    c0 = at_close.get("c0", c0)
    log(f"set-up with the fill before the window {setup_s:.3f} s")
    c1 = at_close["counters"]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rate = w["count"] / w["seconds"]
    log(f"window {w['seconds']:.3f} s: {w['count']} reads, "
        f"{rate:.3f} reads/s; reads fed twice {w['fed_twice']}; "
        f"{', '.join(f'{k} {c1[k] - c0.get(k, 0)}' for k in c1)}")
    clocks = cpu.between(at_close.get("cpu0", at_close["cpu1"]),
                         at_close["cpu1"])
    w["cpu_s"] = clocks["process_cpu_s"]
    log(f"host clocks in the window: {json.dumps(clocks)}; CPU ms a read "
        f"{1000.0 * w['cpu_s'] / max(w['count'], 1)!r}")
    if "bytes_written" in w:
        log(f"bytes written in the window {w['bytes_written']}")
    found = banned_modules()
    if found:
        log(f"modules the port may not load are loaded: {found}")
        return 3

    result_metrics, dev_extra, breakdown = {}, {}, None
    if args.trace:
        anchor = at_close["anchor"]
        t_open, t_close = anchor.t_open, anchor.t_close
        wholes = dict(snap, spans=program.wholes(snap["spans"]))
        residual = []

        def program_spans(events):
            """The program's whole spans on the trace's clock."""
            ev, res = observe.trace_events(wholes, anchor, events)
            residual.append(res)
            return [e for e in ev if e["ph"] == "X"]

        dt = trace.read(prof, tmp_dir, program_spans)
        prof = None
        log(f"program spans: {len(snap['spans'])} records; the anchor's "
            f"residual {residual[0]!r} us")
        data = SimpleNamespace(
            operation=op.operation, window_s=dt.window_s,
            host_window_s=w["seconds"], cpu_s=w["cpu_s"],
            spans=rec.seconds(),
            program_window_s=(t_close - t_open) / 1e9,
            program_spans=program.in_window(snap["spans"], t_open, t_close),
            program_spans_setup=program.before(snap["spans"], t_open),
            main_unspanned_s=program.unspanned(
                snap["spans"], threading.main_thread().native_id, t_open,
                t_close),
            setup_s=setup_s,
            counters={k: c1[k] - c0.get(k, 0) for k in c1},
            kernel_s=dt.kernel_s,
            launch_bytes={k: [counts.resolve(r) for r in v]
                          for k, v in rec.kept().items()},
            busy_s=dt.busy_s, device_events=dt.device_events,
            reads=w["count"])
        rec.records.clear()
        for k in sorted(data.launch_bytes):
            log(f"{k}: {len(data.launch_bytes[k])} launches, "
                f"{sum(data.launch_bytes[k])} bytes; device "
                f"{sum(dt.kernel_s.get(k, []))} s over "
                f"{len(dt.kernel_s.get(k, []))} kernels")
        log("program spans in the window (s): " + json.dumps(
            {k: round(v, 6) for k, v in sorted(data.program_spans.items())}))
        for name, mod in spec.metric_readers(bench_dir).items():
            v = mod.read(data)
            if v is not None:
                result_metrics[name] = {"value": v, "unit": mod.UNIT}
        dev_extra = {"busy_s": dt.busy_s, "window_s": dt.window_s}
        breakdown = {"device_ops": [list(x) for x in dt.top_ops],
                     "idle_gaps": [list(x) for x in dt.idle_gaps]}
        log(f"device trace: {dt.device_events} device events, busy "
            f"{dt.busy_s} s of {dt.window_s} s")
    else:
        result_metrics = op.end_to_end(w)
        result_metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    op.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    got = op.check()
    checks = {k: {"value": got.get(k), "limit": lim}
              for k, lim in cell.limits.items()}
    correct = (set(got) == set(cell.limits)
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    found = banned_modules()
    if found:
        log(f"modules the port may not load are loaded: {found}")
        return 3
    device_rec = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                  "count": cell.chips, "memory_peak_bytes": peak,
                  **dev_extra}
    line = {"correct": correct, "attempted": w["attempted"],
            "failed": w["failed"], "metrics": result_metrics,
            "device": device_rec}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
