#!/usr/bin/env python3
"""Readings of a cell's limits in one process: the program's numbers
compared on many seeds, then its lower-precision control's, after one
set-up (a predict cell's set-up is long; its operation can draw a new
pool and switch to the control):

    python3 benchmark/readings.py --workload <cell> --seconds <s> \\
        --seeds <n,n,...> [--control f32 --control-seeds <n,n,...>]

Each seed gets a short window at the cell's own load (the same pool
size, options and chunks as a run; ``--seconds`` long) and the check of
a run; one JSON line a seed on standard output, with the numbers
compared and the cell's limits. The limits are set from these readings
(PERF.md); a run of the benchmark never calls this.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def seeds(text):
    return [int(x) for x in text.split(",") if x]


def main(argv=None, *, bench_dir=HERE, device="cuda"):
    from benchmark import run
    from benchmark.lib import spec

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--control", default=None)
    p.add_argument("--control-seeds", type=seeds, default=[])
    a = p.parse_args(argv)
    cell = spec.cell(bench_dir, a.workload)
    import torch

    cuda = device == "cuda"
    if cuda and not torch.cuda.is_available():
        run.log("no CUDA device")
        return 2
    tmp_dir = tempfile.mkdtemp(prefix="bench-readings-")
    try:
        ctx = SimpleNamespace(
            seed=a.seeds[0], control=None, device=device,
            config=cell.config, traffic=cell.traffic,
            cache_dir=run.cache_env(bench_dir), tmp_dir=tmp_dir, log=run.log,
            sync=torch.cuda.synchronize if cuda else (lambda: None))
        if cuda:
            run.log(f"card: {run.card_line()}")
        op = spec.load_module(cell.op_path, "bench_op").Op(ctx)
        op.setup()
        for control, group in ((None, a.seeds),
                               (a.control, a.control_seeds)):
            op.use_control(control)
            for seed in group:
                op.reseed(seed)
                w = op.window(a.seconds)
                ctx.sync()
                got = op.check()
                print(json.dumps({
                    "seed": seed, "control": control, "reads": w["count"],
                    "checks": got, "limits": cell.limits,
                    "within": all(got.get(k) is not None and got[k] <= v
                                  for k, v in cell.limits.items())}),
                    flush=True)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    found = run.banned_modules()
    if found:
        run.log(f"modules the port may not load are loaded: {found}")
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
