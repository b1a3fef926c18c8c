"""Each cell's comparison fails what it must: the program's own
lower-precision path (the control) and the faults a cell can have, the
timed path broken underneath a run whose look for a card is skipped."""

from __future__ import annotations

import pytest

from benchmark.tests.conftest import result, run_cell


@pytest.mark.parametrize("cell,control", [
    ("tiny-predict", "f32"), ("tiny_hiseq-subs", "f32"),
    ("tiny-classify", "int8")])
def test_control_is_not_correct(bench, cell, control):
    rc, out, _err = run_cell(bench, cell, "--control", control)
    assert rc == 0
    assert result(out)["correct"] is False


def _half_left_out(monkeypatch):
    """Half of each chunk's reads lose their genes where the device path
    finishes them."""
    from glimmer_mg_torch.ops import device_predict as dpk

    real = dpk.finish_genes

    def finish(outs, n_reads):
        genes, over = real(outs, n_reads)
        return [g if r % 2 else [] for r, g in enumerate(genes)], over

    monkeypatch.setattr(dpk, "finish_genes", finish)


def _score_altered(monkeypatch):
    """Every gene's score off by 0.01 where it is produced."""
    from glimmer_mg_torch.ops import device_predict as dpk

    real = dpk.finish_genes

    def finish(outs, n_reads):
        genes, over = real(outs, n_reads)
        for g in (x for read in genes for x in read):
            g.score += 0.01
        return genes, over

    monkeypatch.setattr(dpk, "finish_genes", finish)


def _coords_altered(monkeypatch):
    """Each read's first gene loses a codon at its start."""
    from glimmer_mg_torch.ops import device_predict as dpk

    real = dpk.finish_genes

    def finish(outs, n_reads):
        genes, over = real(outs, n_reads)
        for read in genes:
            if read:
                read[0].start += 3 if read[0].frame > 0 else -3
        return genes, over

    monkeypatch.setattr(dpk, "finish_genes", finish)


def _scores_half_left_out(monkeypatch):
    """Half of each batch's reads left unscored (zeros)."""
    from glimmer_mg_torch.parallel import phymm

    real = phymm.PhymmBank.score_reads

    def score(self, seqs, *a, **kw):
        out = real(self, seqs, *a, **kw)
        out[1::2] = 0.0
        return out

    monkeypatch.setattr(phymm.PhymmBank, "score_reads", score)


def _raw_altered(monkeypatch):
    """One ICM's score of every read off by 2 where the kernel returns
    it."""
    from glimmer_mg_torch.ops import icm_cuda

    real = icm_cuda.bank_score_both_strands

    def walk(*a, **kw):
        out = real(*a, **kw)
        out[:, 3] += 2.0
        return out

    monkeypatch.setattr(icm_cuda, "bank_score_both_strands", walk)


@pytest.mark.parametrize("cell,fault", [
    ("tiny-predict", _half_left_out), ("tiny-predict", _score_altered),
    ("tiny-predict", _coords_altered), ("tiny_hiseq-subs", _score_altered),
    ("tiny_hiseq-subs", _half_left_out), ("tiny-classify",
                                           _scores_half_left_out),
    ("tiny-classify", _raw_altered)])
def test_fault_is_not_correct(bench, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, out, _err = run_cell(bench, cell)
    assert rc == 0
    assert result(out)["correct"] is False


@pytest.mark.parametrize("cell", ["tiny-predict", "tiny_hiseq-subs",
                                  "tiny-classify"])
def test_program_is_correct_on_other_seeds(bench, cell):
    for seed in (1, 2**31 + 11):
        rc, out, _err = run_cell(bench, cell, seed=seed)
        assert rc == 0 and result(out)["correct"] is True


def test_one_gene_off_fails_the_widest_gap_alone(db_cache):
    """A fault in one gene of the sample: the mean gap, spread over every
    gene, passes its limit; the widest gap fails."""
    import numpy as np

    from benchmark.lib import database
    from benchmark.reference import predict as ref
    from benchmark.tests import tiny
    from benchmark.traffic.reads import make_reads

    db = database.ensure(tiny.config("tiny"), db_cache, log=lambda m: None,
                         processes=2)
    reads, classes, _q = make_reads(db, tiny.config("tiny")["reads"], 40,
                                    np.random.default_rng(23))
    gd = ref.GenomeData(db.icm_dir)
    items = [(s, classes[h], None, ref.plain(ref.reference_genes(
        gd, classes[h], s, None, allow_subs=False, icm_cache={})))
        for h, s in reads]
    k = next(i for i, it in enumerate(items) if it[3])
    key, score = items[k][3][0]
    items[k][3][0] = (key, score + 8e-6)
    got, diag = ref.compare(db.icm_dir, items, allow_subs=False, processes=2)
    limits = tiny.CELLS["tiny-predict"][2]
    assert diag["genes"] > 20 and got["genes_differ"] == 0
    assert got["mean_score_gap"] <= limits["mean_score_gap"]
    assert got["widest_score_gap"] > limits["widest_score_gap"]
