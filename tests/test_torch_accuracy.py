"""The port's gene-level accuracy scoreboard (``glimmer_mg_torch.pipeline.
accuracy``) against the JAX package's (``glimmer_mg_tpu.pipeline.
accuracy``), on a small synthetic stand-in for the sample-run
(``bench_db.build_sample_run``).

The matcher's unit cases of ``tests/test_accuracy.py`` hold for both
modules; seeded ``simulate_reads``, ``project_truth`` and ``evaluate``
agree value for value; ``golden_annotation`` and ``build_accuracy_db``
agree with the JAX functions pointed at the stand-in (equal calls, a
byte-identical tree); ``simulated_benchmark`` on the CPU scores the port's
final ``.predict`` as the JAX ``evaluate`` does with JAX-projected truth;
absent sample-run files raise ``FileNotFoundError``.
"""

import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest

from glimmer_mg_tpu.pipeline import accuracy as jacc
from glimmer_mg_torch import bench_db as tdb
from glimmer_mg_torch.io.fasta import read_fasta
from glimmer_mg_torch.pipeline import accuracy as tacc

from tests._torch_common import (  # noqa: F401 (fixture)
    one_torch_thread, redirect_jax_sample_run, small_sample_run)


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


def _rows(calls):
    return [dataclasses.astuple(g) for g in calls]


@pytest.fixture(scope="module")
def stand_in(tmp_path_factory, one_torch_thread):
    root = tmp_path_factory.mktemp("acc")
    sample_root, _strains = small_sample_run(root / "sample_run")
    db = str(root / "db")
    tacc.build_accuracy_db(db, sample_root=sample_root)
    return sample_root, db


def _units(acc, case):
    """tests/test_accuracy.py's three unit tests, on module ``acc``."""
    G = acc.GeneCall
    if case == "matcher":
        n = 500
        assert acc._matches(G(10, 300, 3), G(40, 300, 3), n, 60)
        assert not acc._matches(G(10, 297, 3), G(40, 300, 3), n, 60)
        assert not acc._matches(G(300, 10, -1), G(10, 300, 1), n, 60)
        assert not acc._matches(G(11, 301, 2), G(10, 300, 3), n, 60)
        assert acc._matches(G(100, 502, 3), G(40, 502, 3), n, 60)
        assert not acc._matches(G(460, 502, 3), G(40, 502, 3), n, 60)
    elif case == "strands":
        ann = [G(101, 400, 1)]
        fwd = acc.project_truth(ann, 51, 550, 1)
        assert len(fwd) == 1 and (fwd[0].start, fwd[0].stop) == (51, 350)
        assert fwd[0].frame > 0
        rev = acc.project_truth(ann, 51, 550, -1)
        assert len(rev) == 1 and (rev[0].start, rev[0].stop) == (450, 151)
        assert rev[0].frame < 0
        assert acc.project_truth(ann, 390, 889, 1, min_overlap=60) == []
    else:
        preds = {"r1": [G(1, 300, 3), G(350, 430, 2)]}
        truth = {"r1": [G(10, 300, 3)], "r2": [G(5, 200, 2)]}
        res = acc.evaluate(preds, truth, {"r1": 500, "r2": 500})
        assert (res.tp, res.fn, res.fp) == (1, 1, 1)
        assert res.sensitivity == 0.5 and res.precision == 0.5


@pytest.mark.parametrize("case", ["matcher", "strands", "counts"])
@pytest.mark.parametrize("acc", [jacc, tacc], ids=["jax", "torch"])
def test_accuracy_units(acc, case):
    _units(acc, case)


def test_simulate_project_evaluate_match_jax(stand_in):
    sample_root, _db = stand_in
    genome = next(read_fasta(os.path.join(sample_root, tacc.GENOME)))[1]
    golden = tacc.golden_annotation(sample_root=sample_root)
    want_reads, want_prov = jacc.simulate_reads(genome, 60, 400, seed=5)
    reads, prov = tacc.simulate_reads(genome, 60, 400, seed=5)
    assert (reads, prov) == (want_reads, want_prov)
    jgold = [jacc.GeneCall(*g) for g in _rows(golden)]
    truth, jtruth = {}, {}
    for (rid, _s), (gs, ge, st) in zip(reads, prov):
        truth[rid] = tacc.project_truth(golden, gs, ge, st, 60,
                                        genome_len=len(genome))
        jtruth[rid] = jacc.project_truth(jgold, gs, ge, st, 60,
                                         genome_len=len(genome))
        assert _rows(truth[rid]) == _rows(jtruth[rid])
    assert sum(map(len, truth.values())) > 20
    # predictions: the truth with seeded drops, shifted stops and flips
    rng = np.random.default_rng(9)
    preds = {}
    for rid, genes in truth.items():
        keep = [tacc.GeneCall(g.start, g.stop + 3 * int(rng.integers(-1, 2)),
                              g.frame * int(rng.choice([1, 1, -1])))
                for g in genes if rng.random() < 0.8]
        if keep:
            preds[rid] = keep
    preds["unknown"] = [tacc.GeneCall(1, 99, 1)]
    lens = {rid: len(s) for rid, s in reads}
    lens["unknown"] = 400
    jpreds = {k: [jacc.GeneCall(*g) for g in _rows(v)]
              for k, v in preds.items()}
    got = tacc.evaluate(preds, truth, lens).as_dict()
    assert got == jacc.evaluate(jpreds, jtruth, lens).as_dict()
    assert 0 < got["tp"] and 0 < got["fn"] and 0 < got["fp"]


def test_golden_and_accuracy_db_match_jax(stand_in, tmp_path, monkeypatch):
    sample_root, db = stand_in
    redirect_jax_sample_run(monkeypatch, sample_root)
    assert _rows(tacc.golden_annotation(sample_root=sample_root)) == _rows(
        jacc.golden_annotation())
    jacc.build_accuracy_db(str(tmp_path / "jax"))
    want = _files(tmp_path / "jax" / "genomeData")
    got = _files(Path(db) / "genomeData")
    assert ".accuracy_db_done" in got and any(
        k.endswith(".gicm") for k in got)
    assert list(got) == list(want)
    assert [k for k in want if got[k] != want[k]] == []


def test_simulated_benchmark_scores_as_jax_evaluate(stand_in, tmp_path,
                                                    monkeypatch):
    sample_root, db = stand_in
    wk = tmp_path / "wk"
    out = tacc.simulated_benchmark(str(wk), sample_root=sample_root,
                                   n_reads=40, device="cpu", db_root=db)
    assert out["truth_source"] == os.path.join(sample_root, tacc.GOLDEN)
    redirect_jax_sample_run(monkeypatch, sample_root)
    genome = next(read_fasta(os.path.join(sample_root, tacc.GENOME)))[1]
    reads, prov = jacc.simulate_reads(genome, 40, 500, seed=11)
    golden = jacc.golden_annotation()
    truth = {rid: jacc.project_truth(golden, gs, ge, st, 60,
                                     genome_len=len(genome))
             for (rid, _s), (gs, ge, st) in zip(reads, prov)}
    preds = jacc.parse_predict((wk / "simreads.predict").read_text())
    want = jacc.evaluate(preds, truth, {r: len(s) for r, s in reads})
    assert {k: out[k] for k in want.as_dict()} == want.as_dict()
    assert out["truth_genes"] == want.tp + want.fn > 20
    assert out["predicted_genes"] == sum(len(v) for v in preds.values()) > 0
    assert (out["n_reads"], out["read_len"]) == (40, 500)


@pytest.mark.parametrize("call", [
    lambda root, tmp: tacc.golden_annotation(sample_root=root),
    lambda root, tmp: tacc.build_accuracy_db(str(tmp / "db"),
                                             sample_root=root),
    lambda root, tmp: tacc.simulated_benchmark(
        str(tmp / "wk"), sample_root=root, device="cpu", n_reads=4),
    lambda root, tmp: tacc.shipped_agreement(
        str(tmp / "wk"), sample_root=root, device="cpu"),
    lambda root, tmp: tdb.bench_reads_and_classes(["a|b"], sample_root=root),
], ids=["golden_annotation", "build_accuracy_db", "simulated_benchmark",
        "shipped_agreement", "bench_reads_and_classes"])
def test_absent_sample_run_raises(call, tmp_path):
    with pytest.raises(FileNotFoundError):
        call(str(tmp_path / "no_sample_run"), tmp_path)
