"""A cell's files, found by name.

    workloads/<cell>.json   {"config", "traffic", "chips", "limits"}
    configs/<config>.json   the deployment (database, reads, options)
    traffic/<traffic>.json  {"operation", ...} the mix's parameters
    ops/<operation>.py      class Op: set-up, window, check
    metrics/<metric>.py     read(trace) -> value or None

A later cell, mix, operation or metric is a new file; none of these
lookups changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def _checked(name, kind):
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def load_module(path, name):
    """Import the Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    op_path: str


def cell(bench_dir, name) -> Cell:
    """The cell ``name`` under ``bench_dir``; raises FileNotFoundError
    for a name with no file."""
    w = _json(os.path.join(bench_dir, "workloads",
                           _checked(name, "workload") + ".json"))
    cfg = _json(os.path.join(bench_dir, "configs",
                             _checked(w["config"], "config") + ".json"))
    tr = _json(os.path.join(bench_dir, "traffic",
                            _checked(w["traffic"], "traffic") + ".json"))
    op = os.path.join(bench_dir, "ops",
                      _checked(tr["operation"], "operation") + ".py")
    if not os.path.exists(op):
        raise FileNotFoundError(op)
    return Cell(name, cfg, tr, int(w.get("chips", 1)), dict(w["limits"]),
                op)


def metric_readers(bench_dir):
    """{metric name: module} of every file in metrics/, in name order;
    a module has ``read(trace)`` and ``UNIT``."""
    d = os.path.join(bench_dir, "metrics")
    out = {}
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".py") and not fn.startswith("_"):
            name = _checked(fn[:-3], "metric")
            out[name] = load_module(os.path.join(d, fn),
                                    "bench_metric_" + name.replace(".", "_")
                                    .replace("-", "_"))
    return out
