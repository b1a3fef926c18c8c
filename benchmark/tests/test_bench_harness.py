"""The harness: files found by name, the result line's form, the
modules it loads."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests.conftest import BENCH, result, run_cell

ROOT = os.path.dirname(BENCH)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell,metric,unit", [
    ("tiny-predict", "predict_reads_per_s", "reads/s"),
    ("tiny_hiseq-subs", "predict_reads_per_s", "reads/s"),
    ("tiny-classify", "classify_reads_per_s", "reads/s")])
def test_last_line_has_the_contract_form(bench, cell, metric, unit):
    rc, out, err = run_cell(bench, cell)
    assert rc == 0
    line = result(out)
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {metric, "setup_s"}
    assert line["metrics"][metric]["unit"] == unit
    assert line["metrics"][metric]["value"] > 0
    assert line["metrics"]["setup_s"]["value"] > 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    # each number compared beside its limit, as the last lines of stderr
    checks = line["checks"]
    tail = err[-len(checks):]
    for (name, c), text in zip(checks.items(), tail):
        assert text.startswith(f"check {name}: ") and "limit" in text
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell,want", [
    ("tiny-predict", {"models_pct", "bank_pct", "host_route_pct"}),
    ("tiny-classify", {"rawmatrix_pct"})])
def test_traced_line_carries_layer_metrics(bench, cell, want):
    rc, out, _err = run_cell(bench, cell, trace=1)
    assert rc == 0
    line = result(out)
    assert want <= set(line["metrics"])
    assert all(m["unit"] == "%" for m in line["metrics"].values())
    assert "busy_s" in line["device"] and "window_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device here: the kernels' rooflines and the idle share stay out
    assert not any(k.endswith("roofline_pct") or k.startswith("device_idle")
                   for k in line["metrics"])


def test_dropped_in_files_are_found(bench):
    """A new config, mix, cell and metric are files; nothing is edited."""
    def dump(kind, name, obj):
        with open(os.path.join(bench, kind, name + ".json"), "w") as fh:
            json.dump(obj, fh)

    with open(os.path.join(bench, "configs", "tiny.json")) as fh:
        cfg = json.load(fh)
    cfg["name"] = "tiny_other"
    cfg["reads"]["length"] = {"fixed": 330}
    dump("configs", "tiny_other", cfg)
    with open(os.path.join(bench, "traffic", "tpredict.json")) as fh:
        tr = json.load(fh)
    tr["pool_reads"] = 90
    dump("traffic", "tother", tr)
    dump("workloads", "tiny_other-other", {
        "config": "tiny_other", "traffic": "tother", "chips": 1,
        "limits": {"genes_differ": 0, "mean_score_gap": 4e-7,
                   "widest_score_gap": 3.5e-6}})
    with open(os.path.join(bench, "metrics", "zz_probe.py"), "w") as fh:
        fh.write('UNIT = "reads"\n\n\ndef read(t):\n'
                 '    return float(t.reads) if t.operation == "predict" '
                 'else None\n')
    rc, out, _err = run_cell(bench, "tiny_other-other", trace=1)
    assert rc == 0
    line = result(out)
    assert line["metrics"]["zz_probe"] == {"value": float(line["attempted"]),
                                           "unit": "reads"}


def test_unknown_cell_is_refused(bench):
    with pytest.raises(FileNotFoundError):
        run_cell(bench, "no_such-cell")


PROBE = """
import sys, time
sys.path.insert(0, {root!r})
from benchmark import run
rc = run.main(["--workload", {cell!r}, "--seed", "5", "--seconds", "0.5",
               "--trace", "1"], bench_dir={bench!r}, device="cpu",
              t_start=time.perf_counter())
top = sorted({{m.split(".")[0] for m in sys.modules}})
print("RC", rc)
print("TOP", " ".join(top))
"""


@pytest.mark.parametrize("cell", ["tiny-predict", "tiny-classify"])
def test_harness_loads_no_jax(bench, cell):
    """The whole run, in a process of its own, loads no module whose
    top-level name is jax, jaxlib, flax or glimmer_mg_tpu (compared
    whole: glimmer_mg_torch begins with glimmer_mg_t...)."""
    code = PROBE.format(root=ROOT, cell=cell, bench=bench)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    lines = p.stdout.splitlines()
    assert "RC 0" in lines, p.stderr[-2000:]
    top = set(next(x for x in lines if x.startswith("TOP ")).split()[1:])
    assert not top & {"jax", "jaxlib", "flax", "glimmer_mg_tpu"}
    assert "glimmer_mg_torch" in top


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.predict, benchmark.reference.classify"
            "\nimport benchmark.reference.walk, benchmark.lib.database\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
            % ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    top = set(p.stdout.split())
    assert "benchmark" in top, p.stderr[-2000:]
    assert not top & {"glimmer_mg_torch", "glimmer_mg_tpu", "jax", "jaxlib",
                      "flax"}


@pytest.mark.cuda
def test_card_cell(card):
    """On the card: one short run of a real cell is correct."""
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "gos_sanger-classify", "--seed", "3000000777", "--seconds", "5",
         "--trace", "0"], capture_output=True, text=True, timeout=1500,
        cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.splitlines()[-1])
    assert line["correct"] is True and line["device"]["kind"] == card
