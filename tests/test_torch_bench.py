"""The port's bench (``python -m glimmer_mg_torch.bench``) at a toy size on
the CPU.

``main`` prints the JAX bench's four rows as JSON lines in its order, the
primary ``glimmer_mg_reads_per_s`` last, each with ``metric``, ``value``,
``unit``, ``vs_baseline`` (null) and ``detail``, every parity flag true. A
parity mismatch forced on the bank walk ends the bench non-zero before its
row is printed; the bench imports no JAX. The bank-walk row on the card is
marked ``cuda`` and skipped without one.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from glimmer_mg_torch import bench
from glimmer_mg_torch.ops import icm_cuda

from tests._torch_common import one_torch_thread  # noqa: F401 (fixture)

REPO = Path(__file__).resolve().parent.parent
TOY = bench.Sizes(strains=2, strain_genes=12, sample_genes=40,
                  sample_reads=30, k2_models=3, k2_batch=16, bank_models=5,
                  bank_batch=8, accuracy_reads=20, reads=64, passes=2,
                  chunks=(16, 64))
METRICS = ["icm_bank_scoring", "gene_accuracy", "glimmer3_whole_genome",
           "glimmer_mg_reads_per_s"]


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cache"))


@pytest.fixture(scope="module")
def prepared(cache, one_torch_thread):
    return bench.prepare(cache, TOY)


@pytest.fixture(scope="module")
def printed(cache, prepared):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--device", "cpu", "--cache-dir", cache], sizes=TOY)
    return rc, out.getvalue()


def _rows(text):
    return [json.loads(line) for line in text.splitlines()]


def test_main_prints_four_rows_primary_last(printed):
    rc, text = printed
    assert rc == 0
    rows = _rows(text)  # every stdout line is a JSON row
    assert [r["metric"] for r in rows] == METRICS
    for r in rows:
        assert set(r) == {"metric", "value", "unit", "vs_baseline", "detail"}
        assert r["vs_baseline"] is None and "baseline" in r["detail"]
        assert r["value"] > 0
    assert [r["unit"] for r in rows] == ["Mbp*models/s", "sensitivity",
                                         "Mbp/s", "reads/s"]


def test_bank_scoring_row(printed):
    row = _rows(printed[1])[0]["detail"]
    for case, (m, b) in ((row, (3, 16)), (row["bank256"], (5, 8))):
        assert (case["models"], case["batch"]) == (m, b)
        assert case["bitwise_equal_twin"] and case["max_abs_err"] == 0.0
        assert len(case["step_ms_runs"]) == bench.STEP_RUNS
        assert case["k2_launches"] == 0  # the CPU runs the twin
    assert row["device"] == "cpu"


def test_gene_accuracy_row(printed):
    row = _rows(printed[1])[1]
    d = row["detail"]
    assert row["value"] == d["sensitivity"]
    assert d["n_reads"] == 20 and d["truth_genes"] > 0
    assert d["truth_source"].endswith("NC_000915.run2.predict")


def test_glimmer3_row(printed):
    d = _rows(printed[1])[2]["detail"]
    assert d["byte_identical_run1"] and len(d["runs_s"]) == 4


def test_reads_per_s_row(printed):
    row = _rows(printed[1])[3]
    d = row["detail"]
    assert d["reads"] == 64 and d["genes"] > 0 and len(d["runs_s"]) == 2
    assert (d["engine"], d["precompute"]) == ("native", "host")
    assert d["counters"]["native_reads"] == 2 * 64
    assert set(d["reads_per_s_by_chunk"]) == {"16", "64"}
    cfg, res = d["device_config"], d["device_resident"]
    assert cfg["byte_identical"] and res["coords_identical"]
    assert (cfg["engine"], cfg["precompute"]) == ("native", "device")
    assert (res["engine"], res["f64"]) == ("device", False)
    assert cfg["counters"]["native_reads"] == 3 * 64
    assert res["counters"]["device_reads"] + res["counters"][
        "host_reads"] == 3 * 64
    assert row["value"] == pytest.approx(64 / d["median_s"])


def test_bank_walk_mismatch_exits_non_zero(printed, cache, monkeypatch,
                                           capsys):
    real = icm_cuda.bank_score_both_strands
    monkeypatch.setattr(icm_cuda, "bank_score_both_strands",
                        lambda *a, **k: real(*a, **k) - 1.0)
    assert bench.main(["--device", "cpu", "--cache-dir", cache],
                      sizes=TOY) == 1
    out, err = capsys.readouterr()
    assert out == ""
    assert "differs from its twin" in err


def test_bench_imports_no_jax(cache):
    script = textwrap.dedent(f"""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "glimmer_mg_tpu"):
                    raise ImportError(name + " is blocked")
                return None

        sys.meta_path.insert(0, Block())
        import torch
        torch.set_num_threads(1)
        from glimmer_mg_torch import bench
        from glimmer_mg_torch.pipeline import accuracy
        sizes = bench.{TOY!r}
        _c, _db, root, _s = bench.prepare({cache!r}, sizes)
        assert bench.glimmer3_whole_genome(root)["detail"][
            "byte_identical_run1"]
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "glimmer_mg_tpu")]
        assert not bad, bad
        print("OK")
    """)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "OK"


@pytest.mark.cuda
def test_bank_scoring_row_on_the_card(prepared):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    sample_root = prepared[2]
    row = bench.icm_bank_scoring(sample_root, "cuda", TOY)
    for case in (row["detail"], row["detail"]["bank256"]):
        assert case["bitwise_equal_twin"] and case["max_abs_err"] == 0.0
        # the checked call, the warm-up, then the timed calls
        assert case["k2_launches"] == 2 + bench.STEP_RUNS * bench.STEP_CALLS
