"""The read-sharded classify cell (``ops/classify_dp4.py``) on the CPU:
a tiny copy of it on 4 gloo ranks, through ``run.main(..., device="cpu")``.

* untraced, the line is correct and carries ``classify_reads_per_s``;
  traced, it carries the mesh's per-layer metrics;
* with two ranks' segments of one raw-matrix row swapped where rank 0
  renders it, ``shard_edge_gap`` is over its limit;
* a set-up that raises in rank 0 returns at once and leaves no rank
  running.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import pytest

from benchmark.tests.conftest import result, run_cell
from benchmark.tests import tiny

CELL = "tiny_dp4-classify"
LIMITS = {"ids_wrong": 0, "raw_gap": 0.5, "table_gap": 0.5, "best_gap": 0.5,
          "shard_edge_gap": 0.5}


@pytest.fixture
def dp4(bench):
    def dump(kind, name, obj):
        with open(os.path.join(bench, kind, name + ".json"), "w") as fh:
            json.dump(obj, fh)

    dump("configs", "tiny_dp4", dict(tiny.config("tiny_dp4"),
                                     mesh={"data": 4, "model": 1}))
    dump("traffic", "tclassify_dp4", {
        "operation": "classify_dp4", "pool_reads": 96, "file_reads": 40,
        "warmup_reads": 20, "batch_per_rank": 4, "check_per_file": 4,
        "check_file_share": 0.5, "fasta_width": 60})
    dump("workloads", CELL, {"config": "tiny_dp4", "traffic": "tclassify_dp4",
                             "chips": 4, "limits": LIMITS})
    return bench


@pytest.fixture
def started(monkeypatch):
    """The processes the run starts."""
    procs = []
    real = subprocess.Popen

    def popen(*a, **k):
        procs.append(real(*a, **k))
        return procs[-1]

    monkeypatch.setattr(subprocess, "Popen", popen)
    return procs


def test_line_is_correct(dp4, started):
    rc, out, _err = run_cell(dp4, CELL)
    assert rc == 0
    line = result(out)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"classify_reads_per_s", "setup_s"}
    assert line["metrics"]["classify_reads_per_s"]["value"] > 0
    assert set(line["checks"]) == set(LIMITS)
    assert len(started) == 3 and all(p.poll() == 0 for p in started)


def test_traced_line_carries_the_mesh_metrics(dp4):
    rc, out, _err = run_cell(dp4, CELL, trace=1)
    assert rc == 0
    m = result(out)["metrics"]
    assert 0 < m["mesh_collective_pct"]["value"] < 100
    assert m["mesh_bytes_per_read"]["value"] > 0
    assert m["mesh_bytes_per_read"]["unit"] == "bytes/read"


def test_swapped_segments_fail(dp4, monkeypatch):
    """Rank 0 renders the first ICMs' rows: in its gathered matrix the
    first ICM's scores of data coordinates 0 and 1 trade places."""
    import torch

    from glimmer_mg_torch.parallel import mesh as pmesh

    real = pmesh.gather_blocks

    def swapped(mesh, block, rows=None):
        whole = real(mesh, block, rows).clone()
        a, b = int(rows[0]), int(rows[1])
        col = whole[:, 0].clone()
        whole[:a + b, 0] = torch.cat([col[a:a + b], col[:a]])
        return whole

    monkeypatch.setattr(pmesh, "gather_blocks", swapped)
    rc, out, _err = run_cell(dp4, CELL)
    assert rc == 0
    line = result(out)
    assert line["correct"] is False
    assert line["checks"]["shard_edge_gap"]["value"] > 0.5


def test_setup_failure_leaves_no_rank(dp4, started, monkeypatch):
    from glimmer_mg_torch.parallel import phymm

    def planted(*a, **k):
        raise RuntimeError("planted set-up fault")

    monkeypatch.setattr(phymm.PhymmBank, "from_genome_data", planted)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="planted"):
        run_cell(dp4, CELL)
    assert time.monotonic() - t0 < 60
    assert len(started) == 3 and all(p.poll() is not None for p in started)
    assert "RANK" not in os.environ
