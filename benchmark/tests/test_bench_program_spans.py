"""The program's span-and-counter recorder (``glimmer_mg_torch.utils.
observe``) under the harness: the untraced line keeps exactly its keys and
the run leaves the recorder off and the program's record empty."""

from __future__ import annotations

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
