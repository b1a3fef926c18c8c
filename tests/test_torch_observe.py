"""The port's span-and-counter recorder (``glimmer_mg_torch.utils.observe``)
on the CPU.

* off, it records nothing and hands out one shared no-op context;
* on, it records nested spans with thread CPU time from two threads under
  distinct thread ids, a span's summed parts, and counters that add up
  under a short switch interval;
* ``trace_events`` places host spans on a Chrome trace's clock through
  the anchor annotation: exactly on a synthetic trace, and within 5 ms
  (a loaded test machine can pre-empt a thread between the profiler's
  stamp and the anchor's) on a real ``torch.profiler`` trace;
* the raw matrix, the results table and a ``run_glimmer_mg_classes``
  output with the chunk overlap on (so the worker thread runs) are
  byte-identical with the recorder on and off, and the two files equal
  the plain writers' bytes;
* ``PhymmBank`` records its set-up parts, and ``score_reads`` on the
  bank walk's CPU twin counts four host syncs a K2 call (the two uploads,
  the range check, the fetch; ``test_torch_bank_walk_cuda.py`` holds the
  count to the syncs CUDA reports on the card);
* ``StageTimers`` stages are spans ``stage.<name>``;
* the pipeline's ``profile_dir`` trace holds ``program_span`` events from
  the worker thread and the counters, and leaves the recorder off.
"""

import json
import sys
import threading
import time

import numpy as np
import pytest

from glimmer_mg_torch.engine import glimmer_mg as tmg
from glimmer_mg_torch.io.genome_data import GenomeData
from glimmer_mg_torch.parallel import phymm
from glimmer_mg_torch.pipeline import glimmer_mg_pipe as tpipe
from glimmer_mg_torch.utils import observe

from tests._torch_common import (  # noqa: F401
    class_map, mg_db, one_torch_thread)


@pytest.fixture(autouse=True)
def fresh_recorder():
    observe.disable()
    observe.reset()
    yield
    observe.disable()
    observe.reset()


def _names(rec):
    return [s.name for s in rec["spans"]]


def _busy(seconds):
    end = time.perf_counter() + seconds
    n = 0
    while time.perf_counter() < end:
        n += 1
    return n


def test_off_records_nothing():
    assert not observe.enabled()
    a, b = observe.span("x.a", reads=3), observe.span("x.b")
    assert a is b  # one shared no-op context
    with a as sp:
        with sp.part("text"):
            pass
        sp.set(rows=2)
    observe.count("c", 5)
    timers = observe.StageTimers()
    with timers.stage("s"):
        pass
    rec = observe.snapshot()
    assert rec["spans"] == [] and "c" not in rec["counters"]
    assert [st.name for st in timers.stages] == ["s"]


def test_nested_spans_and_cpu_time_on_two_threads():
    observe.enable()

    def worker():
        with observe.span("t.worker", reads=7):
            _busy(0.05)

    th = threading.Thread(target=worker, name="probe-worker")
    with observe.span("t.outer") as outer:
        with observe.span("t.inner"):
            time.sleep(0.05)  # wall time, little CPU
        th.start()
        th.join(timeout=30)
        outer.set(rows=2)
    assert not th.is_alive()
    rec = observe.snapshot()
    by = {s.name: s for s in rec["spans"]}
    assert _names(rec) == ["t.inner", "t.worker", "t.outer"]
    inner, wk, out = by["t.inner"], by["t.worker"], by["t.outer"]
    assert out.t0 <= inner.t0 < inner.t1 <= out.t1
    assert out.t0 <= wk.t0 < wk.t1 <= out.t1
    assert inner.tid == out.tid == threading.get_native_id()
    assert wk.tid != out.tid
    assert rec["threads"][wk.tid] == "probe-worker"
    assert inner.wall == inner.t1 - inner.t0 >= 40_000_000
    assert inner.cpu < inner.wall / 2  # asleep
    assert wk.cpu > wk.wall / 4  # spinning (the main thread sleeps in join)
    assert wk.attrs == {"reads": 7} and out.attrs == {"rows": 2}


def test_parts_sum_into_one_record():
    observe.enable()
    with observe.span("w.file") as sp:
        text, io = sp.part("text"), sp.part("io")
        for _ in range(3):
            with text:
                time.sleep(0.01)
            with io:
                pass
    rec = observe.snapshot()
    by = {s.name: s for s in rec["spans"]}
    assert sorted(by) == ["w.file", "w.file.io", "w.file.text"]
    whole, t = by["w.file"], by["w.file.text"]
    assert (t.t0, t.t1) == (whole.t0, whole.t1)
    assert 30_000_000 <= t.wall <= whole.wall
    assert by["w.file.io"].wall < t.wall


def test_counters_add_up_across_threads():
    observe.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(2000):
                observe.count("hits")
                observe.count("pairs", 2)

        threads = [threading.Thread(target=bump) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    c = observe.snapshot()["counters"]
    assert c["hits"] == 32000 and c["pairs"] == 64000


def test_snapshot_folds_in_the_ports_counters():
    from glimmer_mg_torch.ops import icm_cuda, raw_text_cuda

    c = observe.snapshot()["counters"]
    assert c["bank_walk_launches"] == icm_cuda.bank_walk_launches
    assert c["six_frame_launches"] == icm_cuda.launches
    assert c["raw_text_launches"] == raw_text_cuda.launches
    for k, v in tmg.counters.items():
        assert c[k] == v


def test_anchor_maps_spans_onto_a_synthetic_trace():
    """Host clock (ns) 5e9 + x maps to trace time (us) 1,000 + x / 1,000."""
    anchor = observe.Anchor("probe.anchor")
    anchor.t_open, anchor.t_close = 5_000_000_000, 5_002_000_000
    events = [{"ph": "X", "cat": "user_annotation", "name": "probe.anchor",
               "pid": 9, "tid": 9, "ts": 1000.0, "dur": 2000.05}]
    spans = [observe.SpanRecord("a.b", 11, 5_000_500_000, 5_000_700_000,
                                200_000, 150_000, {"reads": 4}),
             observe.SpanRecord("a.c", 12, 4_000_000_000, 4_000_000_100,
                                100, 100, {})]  # before the anchor
    got, residual = observe.trace_events(
        {"spans": spans, "threads": {11: "gmt-engine_0"}}, anchor, events)
    assert residual == pytest.approx(-0.05, abs=1e-6)
    meta = [e for e in got if e["ph"] == "M"]
    assert meta == [{"ph": "M", "name": "thread_name", "pid": 9, "tid": 11,
                     "args": {"name": "gmt-engine_0"}}]
    (ev,) = [e for e in got if e["ph"] == "X"]
    assert ev["cat"] == "program_span" and ev["name"] == "a.b"
    assert (ev["pid"], ev["tid"]) == (9, 11)
    assert ev["ts"] == pytest.approx(1500.0, abs=1e-3)
    assert ev["dur"] == pytest.approx(200.0, abs=1e-3)
    assert ev["args"] == {"wall_us": 200.0, "cpu_us": 150.0, "reads": 4}


def test_anchor_maps_spans_onto_a_profiler_trace(tmp_path):
    """A span recorded on a worker thread, whose record_function would not
    reach the trace, lands inside a main-thread annotation it ran in."""
    import torch

    observe.enable()
    anchor = observe.Anchor("probe.window")

    def worker():
        with observe.span("probe.worker"):
            time.sleep(0.02)

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with anchor:
            with torch.profiler.record_function("probe.main"):
                time.sleep(0.02)
                th = threading.Thread(target=worker)
                th.start()
                th.join(timeout=30)
                time.sleep(0.02)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    got, residual = observe.trace_events(observe.snapshot(), anchor, events)
    assert abs(residual) < 5000
    main = next(e for e in events if e.get("name") == "probe.main")
    (wk,) = [e for e in got if e.get("name") == "probe.worker"]
    assert wk["tid"] != main["tid"]
    assert main["ts"] - 5000 <= wk["ts"]
    assert wk["ts"] + wk["dur"] <= main["ts"] + main["dur"] + 5000


# -- the program's outputs, on and off ---------------------------------------


def _plain_raw(path, icm_paths, read_ids, scores):
    """The raw matrix as the reference's writer loops write it."""
    with open(path, "w") as fh:
        fh.write("BEGIN_ICM_LIST\n")
        for p in icm_paths:
            fh.write(p + "\n")
        fh.write("END_ICM_LIST\nBEGIN_READID_LIST\n")
        for r in read_ids:
            fh.write(r + "\n")
        fh.write("END_READID_LIST\nBEGIN_DATA_MATRIX\n")
        for g in range(len(icm_paths)):
            fh.write(" ".join("%.4f" % s for s in scores[:, g]) + "\n")
        fh.write("END_DATA_MATRIX\n")


def _plain_table(path, read_ids, icm_paths, scores, taxonomy):
    best = np.argmax(scores, axis=1)
    with open(path, "w") as fh:
        fh.write("QUERY_ID\tBEST_MATCH\tSCORE\tGENUS\tFAMILY\tORDER\tCLASS"
                 "\tPHYLUM\n")
        for i, rid in enumerate(read_ids):
            strain = phymm.path_to_genome(icm_paths[best[i]]).split("|")[0]
            ranks = taxonomy.get(strain, ("", "", "", "", ""))
            fh.write("%s\t%s\t%.4f\t%s\n"
                     % (rid, strain, scores[i, best[i]], "\t".join(ranks)))


@pytest.fixture(scope="module")
def bank(mg_db, one_torch_thread):
    root, icm_dir, reads, _truth = mg_db
    return phymm.PhymmBank.from_genome_data(str(icm_dir), "cpu"), reads


def test_phymm_files_are_identical_on_and_off(bank, tmp_path):
    b, reads = bank
    ids = [h for h, _ in reads]
    scores = b.score_reads([s.lower() for _, s in reads], batch=16)
    scores[3, 1] = -0.00005  # rounds to "-0.0000" in both
    tax = {phymm.path_to_genome(b.paths[0]).split("|")[0]:
           ("g", "f", "o", "c", "p")}
    _plain_raw(tmp_path / "plain_raw", b.paths, ids, scores)
    _plain_table(tmp_path / "plain_table", ids, b.paths, scores, tax)
    for tag in ("off", "on"):
        if tag == "on":
            observe.enable()
        phymm.write_raw_phymm_output(tmp_path / f"{tag}_raw", b.paths, ids,
                                     scores)
        phymm.write_results_table(tmp_path / f"{tag}_table", ids, b.paths,
                                  scores, tax)
    for kind in ("raw", "table"):
        want = (tmp_path / f"plain_{kind}").read_bytes()
        assert (tmp_path / f"off_{kind}").read_bytes() == want
        assert (tmp_path / f"on_{kind}").read_bytes() == want
    rec = observe.snapshot()
    assert sorted(_names(rec)) == [
        "phymm.raw_matrix", "phymm.raw_matrix.io", "phymm.raw_matrix.text",
        "phymm.results_table", "phymm.results_table.io",
        "phymm.results_table.text"]
    assert rec["counters"]["raw_matrix_bytes"] == len(
        (tmp_path / "plain_raw").read_bytes())
    by = {s.name: s for s in rec["spans"]}
    whole = by["phymm.raw_matrix"]
    assert whole.attrs == {"rows": len(b.paths), "reads": len(ids)}
    assert (by["phymm.raw_matrix.text"].wall + by["phymm.raw_matrix.io"].wall
            <= whole.wall)


def test_bank_and_score_reads_spans_and_four_syncs_per_k2_call(
        mg_db, one_torch_thread, monkeypatch):
    """On the CPU twin no kernel launches, so K2's calls are counted by
    their checks, each one ``k2.check`` whose value check the slab's scope
    skips (``k2_checked_by_construction``). A slab of 24 reads is encoded,
    uploaded and padded once (``phymm.score.pad``) and downloaded once, its
    one host sync; the uploads make none."""
    root, icm_dir, reads, _truth = mg_db
    monkeypatch.setattr(phymm, "SLAB_READS", 24)
    observe.enable()
    b = phymm.PhymmBank.from_genome_data(str(icm_dir), "cpu")
    progress = observe.ProgressLog(None, len(reads), every=50)
    b.score_reads([s.lower() for _, s in reads], batch=8, progress=progress)
    rec = observe.snapshot()
    names = _names(rec)
    calls = -(-len(reads) // 8)
    slabs = -(-len(reads) // 24)
    assert slabs > 1
    assert names[:4] == ["phymm.bank.read", "phymm.bank.stack",
                         "phymm.bank.pack", "phymm.bank.upload"]
    by = {s.name: s for s in rec["spans"]}
    assert by["phymm.bank.read"].attrs == {"icms": len(b.paths)}
    assert by["phymm.bank.upload"].attrs == {
        "bytes": sum(t.numel() * t.element_size() for t in b.tables)}
    for name in ("phymm.score.pad", "phymm.score.fetch", "phymm.progress"):
        assert names.count(name) == slabs, name
    assert names.count("k2.check") == calls
    assert "k2.launch" not in names  # the CPU twin launches nothing
    assert rec["counters"]["k2_host_syncs"] == slabs
    assert rec["counters"]["k2_checked_by_construction"] == calls
    assert progress.done == len(reads)


def test_stage_timers_are_spans():
    observe.enable()
    timers = observe.StageTimers()
    with timers.stage("phymm", log=False) as st:
        st.items, st.bp = 30, 18000
    (s,) = observe.snapshot()["spans"]
    assert s.name == "stage.phymm" and s.attrs == {"items": 30, "bp": 18000}
    assert timers.stages[0].wall_s * 1e9 <= s.wall + 1e6


def test_classes_output_identical_on_and_off_with_the_worker(
        mg_db, one_torch_thread, monkeypatch):
    root, icm_dir, reads, _truth = mg_db
    monkeypatch.setenv("GLIMMER_MG_TPU_OVERLAP", "1")
    gd = GenomeData(str(icm_dir))
    cmap = class_map(reads, ["alpha|chrA", "beta|chrB"], pair_every=3)

    def run():
        return tmg.format_predict_mg(list(tmg.run_glimmer_mg_classes(
            reads, gd, cmap, device="cpu", chunk_size=8)))

    off = run()
    observe.enable()
    on = run()
    assert on == off and off.count(">") == len(reads)
    rec = observe.snapshot()
    main = threading.get_native_id()
    worker = {s.name for s in rec["spans"] if s.tid != main}
    assert {"predict.chunk_batch", "predict.bank_build", "predict.k1",
            "predict.kf", "predict.k3", "predict.fetch"} <= worker
    mains = {s.name for s in rec["spans"] if s.tid == main}
    assert {"predict.models", "predict.wait"} <= mains
    c = rec["counters"]
    assert c["models_cache_miss"] == _names(rec).count("predict.models")
    assert c["models_cache_hit"] + c["models_cache_miss"] == len(reads)
    assert c["bank_cache_miss"] == _names(rec).count("predict.bank_build")


def test_pipeline_profile_trace_has_worker_spans(mg_db, one_torch_thread,
                                                 monkeypatch, tmp_path):
    root, icm_dir, _reads, _truth = mg_db
    monkeypatch.setenv("GLIMMER_MG_TPU_OVERLAP", "1")
    prof = tmp_path / "prof"
    tpipe.run_pipeline(str(root / "reads.fa"), str(icm_dir), device="cpu",
                       workdir=str(tmp_path / "w"), iterate=0,
                       profile_dir=str(prof))
    assert not observe.enabled()
    (path,) = prof.glob("*.pt.trace.json")
    trace = json.loads(path.read_text())
    assert trace["programSpans"]["anchor"] == observe.PROFILE_ANCHOR
    assert abs(trace["programSpans"]["residual_us"]) < 5000
    c = trace["programSpans"]["counters"]
    for k in ("raw_matrix_bytes", "k2_host_syncs", "models_cache_miss",
              "bank_cache_miss"):
        assert c[k] > 0, k
    assert set(tmg.counters) | {"bank_walk_launches",
                                "six_frame_launches"} <= set(c)
    spans = [e for e in trace["traceEvents"]
             if e.get("cat") == "program_span"]
    main = threading.get_native_id()
    names = {e["name"] for e in spans}
    assert {"stage.phymm", "stage.iter0", "phymm.raw_matrix.text",
            "k2.check", "predict.models"} <= names
    worker = {e["name"] for e in spans if e["tid"] != main}
    assert {"predict.k1", "predict.kf", "predict.k3"} <= worker
    rows = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
            if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert any(rows.get(t, "").startswith("gmt-engine")
               for t in {e["tid"] for e in spans if e["tid"] != main})
