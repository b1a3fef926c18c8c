"""The program's span-and-counter recorder (``glimmer_mg_torch.utils.
observe``) under the harness: the untraced line keeps exactly its keys and
the run leaves the recorder off and the program's record empty; a traced
run reads the layers from the program's spans, clipped to the window, and
labels the device's idle gaps by them."""

from __future__ import annotations

import pytest

from benchmark.tests.conftest import result, run_cell

LINE = {"correct", "attempted", "failed", "metrics", "device", "checks"}
DEVICE = {"platform", "kind", "count", "memory_peak_bytes"}


def test_an_untraced_run_leaves_the_recorder_off_and_empty(bench):
    from glimmer_mg_torch.utils import observe

    observe.disable()
    observe.reset()
    rc, out, _err = run_cell(bench, "tiny-classify", trace=0)
    assert rc == 0
    line = result(out)
    assert not observe.enabled()
    assert observe.snapshot()["spans"] == []
    assert set(line) == LINE
    assert set(line["device"]) == DEVICE
    assert set(line["metrics"]) == {"classify_reads_per_s", "setup_s"}


CLASSIFY_LAYERS = {"rawmatrix_pct", "k2_host_pct", "output_text_pct",
                   "output_io_pct", "unspanned_pct.classify",
                   "setup_bank_pct"}


def test_a_traced_run_reads_the_programs_spans(bench):
    """The layers of classification from the program's own spans; K2's
    syncs a launch and KT's roofline read nothing on the CPU twin (no
    launch), and the recorder is off and empty afterwards."""
    from glimmer_mg_torch.utils import observe

    observe.disable()
    observe.reset()
    rc, out, err = run_cell(bench, "tiny-classify", trace=1)
    assert rc == 0
    line = result(out)
    assert line["correct"] is True
    metrics = line["metrics"]
    assert CLASSIFY_LAYERS <= set(metrics)
    assert "k2_syncs_per_launch" not in metrics
    assert "kt_roofline_pct" not in metrics
    for name in CLASSIFY_LAYERS:
        assert 0.0 < metrics[name]["value"] <= 100.0, name
    assert not observe.enabled()
    assert observe.snapshot()["spans"] == []
    labels = [g[0] for g in line["breakdown"]["idle_gaps"]]
    assert labels and all(x == "outside the program's spans"
                          or x.startswith(("phymm.", "k2.")) for x in labels)
    # the window's counters come from the program's recorder
    window = next(x for x in err if x.startswith("window "))
    assert "k2_host_syncs" in window


def rec(name, tid, t0, t1, wall=None):
    from glimmer_mg_torch.utils.observe import SpanRecord

    return SpanRecord(name, tid, t0, t1, t1 - t0 if wall is None else wall,
                      0, {})


def test_window_clipping_of_spans_and_parts():
    from benchmark.lib import program

    spans = [
        rec("a", 1, 0, 200),        # across the window's opening
        rec("b", 1, 900, 1200),     # across its closing
        rec("w", 1, 300, 700),      # a whole span with a part inside
        rec("w.io", 1, 300, 700, wall=100),
        rec("x.text", 1, 50, 250, wall=80),  # a part across the opening
        rec("x", 1, 50, 250),
        rec("c", 2, 400, 600),      # on another thread
        rec("d", 1, 10, 40),        # closed before the window
    ]
    t_open, t_close = 100, 1000
    got = program.in_window(spans, t_open, t_close)
    want = {"a": 100, "b": 100, "w": 400, "w.io": 100, "x": 150,
            "x.text": 80 * 150 / 200, "c": 200}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert abs(got[k] - v / 1e9) < 1e-15, k
    assert {s.name for s in program.wholes(spans)} == {
        "a", "b", "w", "x", "c", "d"}
    assert program.before(spans, t_open) == {"d": 30 / 1e9}
    # thread 1 is inside a, x, w, b over [100, 250] + [300, 700] +
    # [900, 1000]; the part and thread 2's span do not count
    assert abs(program.unspanned(spans, 1, t_open, t_close)
               - 250 / 1e9) < 1e-15
    assert program.unspanned(spans, 2, t_open, t_close) == 700 / 1e9
    assert program.unspanned(spans, 3, t_open, t_close) == 900 / 1e9


def test_idle_gaps_are_labelled_by_the_innermost_span():
    from benchmark.lib import trace

    events = [
        {"name": trace.WINDOW, "ph": "X", "ts": 0, "dur": 100},
        {"name": "walk_kernel", "cat": "kernel", "ph": "X", "ts": 40,
         "dur": 20},
    ]
    program = [
        {"name": "phymm.score", "ph": "X", "tid": 1, "ts": 10, "dur": 60},
        {"name": "phymm.score.pad", "ph": "X", "tid": 1, "ts": 15,
         "dur": 20},
        {"name": "empty", "ph": "X", "tid": 1, "ts": 5, "dur": 0},
    ]
    dt = trace.DeviceTrace(events, lambda ev: program)
    # [0, 40]: its middle 20 under phymm.score.pad; [60, 100]: at 80
    # outside every span
    assert dict(dt.idle_gaps) == pytest.approx(
        {"phymm.score.pad": 40e-6, trace.OUTSIDE: 40e-6})
    assert dt.kernel_s["k2"] == pytest.approx([20e-6])
