"""The frozen copies under benchmark/ agree with the port's code they were
copied from, at a tiny size (this test imports both; the benchmark's
reference imports nothing of the port)."""

from __future__ import annotations

import filecmp
import os

import numpy as np
import pytest
import torch

from benchmark.lib import counts, database
from benchmark.tests import tiny
from benchmark.traffic import generators
from benchmark.traffic.reads import make_reads


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return database.ensure(tiny.config("t"), str(tmp_path_factory.mktemp("c")),
                           log=lambda m: None, processes=2)


def test_trainer_copy_writes_the_ports_files(tmp_path):
    from benchmark.reference.gm.pipeline.train_all import train_genome as ref
    from glimmer_mg_torch.pipeline.train_all import train_genome as port

    seq = generators.synth_genome(np.random.default_rng(11), 0.45, 30000)
    ref(seq, "chr", str(tmp_path / "ref"))
    port(seq, "chr", str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "ref"))
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "port", tmp_path / "ref", names, shallow=False)
    assert not mismatch and not errors


@pytest.mark.parametrize("subs", [False, True])
def test_host_engine_copy_gives_the_ports_genes(db, subs):
    from benchmark.reference import predict as ref
    from glimmer_mg_torch.engine import glimmer_mg as tmg
    from glimmer_mg_torch.io.genome_data import GenomeData

    err = ({"kind": "substitutions_from_quality", "quality": tiny.QUALITY}
           if subs else None)
    spec = tiny.config("t", err, {"fixed": 270} if subs else None)["reads"]
    reads, classes, quals = make_reads(db, spec, 12,
                                       np.random.default_rng(5))
    port = dict(tmg.run_glimmer_mg_classes(
        reads, GenomeData(db.icm_dir), classes, device="cpu", engine="host",
        qualities=quals, allow_subs=subs))
    gd = ref.GenomeData(db.icm_dir)
    n_genes = 0
    for h, s in reads:
        want = ref.reference_genes(gd, classes[h], s,
                                   None if quals is None else quals[h],
                                   allow_subs=subs, icm_cache={})
        got = port[h]
        assert [ref.gene_key(g) for g in got] == [ref.gene_key(g)
                                                  for g in want]
        assert [g.score for g in got] == [g.score for g in want]
        n_genes += len(got)
    assert n_genes > 0


def test_exact_walk_copy_gives_the_ports_scores(db):
    from benchmark.reference.walk import Bank
    from glimmer_mg_torch.parallel import classify as pclassify
    from glimmer_mg_torch.parallel.phymm import PhymmBank

    pb = PhymmBank.from_genome_data(db.icm_dir, "cpu")
    reads, _c, _q = make_reads(db, tiny.config("t")["reads"], 5,
                               np.random.default_rng(6))
    r, lengths = pclassify.pad_reads([s for _h, s in reads], length=522)
    port, _best = pclassify.classify_step(
        *(torch.from_numpy(a) for a in (pb.mip, pb.probs)),
        torch.from_numpy(r), torch.from_numpy(lengths), pb.model_len,
        pb.depth)
    bank = Bank(pb.paths, "cpu")
    for k, (_h, s) in enumerate(reads):
        seq = torch.tensor(["acgt".index(c) for c in s])
        want = bank.classify(seq).numpy()
        # the port adds f32 per-base values in f32; the copy adds in f64
        assert np.allclose(port[k].numpy(), want, rtol=0, atol=2e-3)


def test_byte_counts_match_the_smokes_on_unpadded_inputs():
    import chip_smoke

    B, Lp, E = 3, 96, 20
    seq = torch.zeros((B, Lp), dtype=torch.int32)
    n = torch.full((B,), Lp, dtype=torch.int32)
    gi = torch.zeros(B, dtype=torch.int32)
    g6 = torch.zeros((B, 6, Lp))
    bank = {k: torch.zeros(5, dtype=torch.float64) for k in counts.KF_TABLES}
    ev = {"pos": torch.zeros((B, E), dtype=torch.int32),
          "typ": torch.zeros((B, E), dtype=torch.int32),
          "sub": torch.zeros((B, E), dtype=torch.int32),
          "id": torch.zeros((B, E), dtype=torch.int32),
          "score": torch.zeros((B, E), dtype=torch.float64),
          "trunc": torch.zeros((B, E), dtype=torch.bool)}
    n_events = torch.full((B,), E, dtype=torch.int32)
    args = (seq, n, gi, g6, g6, bank, Lp)
    assert counts.resolve(counts.kf_record(
        *args, ev, n_events, None)) == chip_smoke.kf_bytes(args, ev)
    tables = {k: torch.zeros(4 + i) for i, k in enumerate(counts.K3_TABLES)}
    outs = (None,) * 12 + (torch.full((B,), counts.MAX_GENES),)
    assert counts.resolve(counts.k3_record(
        ev, tables, gi, n_events, outs)) == chip_smoke.k3_bytes(ev, tables, B)
