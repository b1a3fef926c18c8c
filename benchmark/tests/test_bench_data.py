"""Generators and the database are fixed by their seeds; byte counts
ignore padding."""

from __future__ import annotations

import hashlib
import os

import numpy as np
import pytest
import torch

from benchmark.lib import counts, database
from benchmark.tests import tiny
from benchmark.traffic import generators, reads as reads_mod


def tree_digest(root):
    h = hashlib.sha256()
    for d, _sub, files in sorted(os.walk(root)):
        for f in sorted(files):
            p = os.path.join(d, f)
            h.update(os.path.relpath(p, root).encode())
            with open(p, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return database.ensure(tiny.config("t"), str(tmp_path_factory.mktemp("c")),
                           log=lambda m: None, processes=2)


def test_database_is_fixed_by_its_keys(db, tmp_path):
    again = database.ensure(tiny.config("t"), str(tmp_path),
                            log=lambda m: None, processes=2)
    assert tree_digest(again.root) == tree_digest(db.root)
    assert len(db.entries) == tiny.DB["entries"]
    files = os.listdir(os.path.join(db.icm_dir, "e005"))
    assert "chr.icm" in files and "chr.gicm" in files and "chr.motif" in files
    # a marker makes the next call a load, not a build
    assert database.ensure(tiny.config("t"), os.path.dirname(db.root),
                           log=pytest.fail).root == db.root


def test_derived_entries_differ_from_their_source(db):
    from benchmark.reference.gm.models.icm import read_icm

    a = read_icm(os.path.join(db.icm_dir, "t0", "chr.gicm"))
    b = read_icm(os.path.join(db.icm_dir, "e002", "chr.gicm"))
    assert np.array_equal(a.mip, b.mip)
    assert not np.array_equal(a.probs, b.probs)
    assert np.allclose(a.probs, b.probs, rtol=0.1)


@pytest.mark.parametrize("errors", [None, {
    "kind": "substitutions_from_quality", "quality": tiny.QUALITY}])
def test_reads_are_fixed_by_the_seed(db, errors):
    spec = tiny.config("t", errors)["reads"]
    one = reads_mod.make_reads(db, spec, 300, np.random.default_rng(2**31 + 5))
    two = reads_mod.make_reads(db, spec, 300, np.random.default_rng(2**31 + 5))
    other = reads_mod.make_reads(db, spec, 300, np.random.default_rng(9))
    assert one[0] == two[0] and one[1] == two[1]
    assert one[0] != other[0]
    if errors is not None:
        assert all(np.array_equal(one[2][h], two[2][h]) for h in one[2])
        q = np.concatenate(list(one[2].values()))
        assert q.min() >= 2 and q.max() <= 41
    for h, s in one[0]:
        assert set(s) <= set("acgt") and 300 <= len(s) <= 520
        cls = one[1][h]
        assert len(cls) == 3 and len(set(cls)) == 3


def test_every_seed_gets_the_same_abundances():
    a = reads_mod.abundances(539, 2.0, np.random.default_rng(1))
    b = reads_mod.abundances(539, 2.0, np.random.default_rng(2))
    assert np.allclose(np.sort(a), np.sort(b)) and not np.allclose(a, b)
    assert abs(a.sum() - 1) < 1e-12


def test_reads_come_from_their_entry_genome(db):
    spec = dict(tiny.config("t")["reads"], revcomp=0.0)
    rd, cls, _q = reads_mod.make_reads(db, spec, 50,
                                       np.random.default_rng(4))
    text = db.genome_flat.tobytes().decode()
    for h, s in rd:
        e = db.entries.index(cls[h][0])
        g = int(db.genome_of[e])
        a = int(db.genome_start[g])
        assert s in text[a:a + int(db.genome_len[g])]


def test_synth_genome_is_fixed_by_the_seed():
    a = generators.synth_genome(np.random.default_rng(3), 0.5, 5000)
    b = generators.synth_genome(np.random.default_rng(3), 0.5, 5000)
    assert a == b and len(a) == 5000


def _kf_inputs(B, Lp, E, lens, pad=0):
    n = torch.tensor(lens, dtype=torch.int32)
    seq = torch.zeros((B, Lp + pad), dtype=torch.int32)
    g6 = torch.zeros((B, 6, Lp + pad), dtype=torch.float32)
    ev = {k: torch.zeros((B, E), dtype=dt) for k, dt in (
        ("pos", torch.int32), ("typ", torch.int32), ("sub", torch.int32),
        ("id", torch.int32), ("score", torch.float64),
        ("trunc", torch.bool))}
    bank = {k: torch.zeros(7) for k in counts.KF_TABLES}
    ne = torch.tensor([min(5 + 3 * i, E) for i in range(B)], dtype=torch.int32)
    return seq, n, g6, ev, bank, ne


def test_byte_counts_ignore_padding():
    lens = [300, 511, 0, 64]
    a = counts.resolve(counts.kf_record(*_kf_args(lens, 0)))
    b = counts.resolve(counts.kf_record(*_kf_args(lens, 256)))
    assert a == b
    reads = torch.randint(0, 4, (4, 512), dtype=torch.int32)
    lengths = torch.tensor(lens, dtype=torch.int32)
    out = torch.zeros((4, 9))
    tabs = (torch.zeros((9, 3, 4, 128), dtype=torch.int32),
            torch.zeros((9, 3, 8, 128), dtype=torch.int32))
    k2a = counts.resolve(counts.k2_record(*tabs, reads, lengths, out))
    k2b = counts.resolve(counts.k2_record(
        *tabs, torch.nn.functional.pad(reads, (0, 300)), lengths, out))
    assert k2a == k2b


def _kf_args(lens, pad):
    seq, n, g6, ev, bank, ne = _kf_inputs(len(lens), 512, 40, lens, pad)
    gi = torch.zeros(len(lens), dtype=torch.int32)
    return seq, n, gi, g6, g6, bank, 512 + pad, ev, ne, None


def test_k1_table_entries_ignore_padding(db):
    from benchmark.reference.gm.engine.classes import classes_models
    from benchmark.reference.gm.io.genome_data import GenomeData

    gd = GenomeData(db.icm_dir)
    models = [classes_models(
        [db.entries[k]], 400, gd, parsed=None, user_icm=None, user_gc=None,
        user_rbs_pwm=None, user_stop_codons=None,
        fudge_f32=np.float32(1.0), min_gene_len=75, max_olap_bases=50,
        circular=False, icm_cache={}) for k in (0, 1)]
    reads = torch.randint(0, 4, (3, 512), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(1))
    lengths = torch.tensor([400, 100, 512], dtype=torch.int32)
    group = torch.tensor([0, 1, 0], dtype=torch.int32)
    a = counts.resolve(counts.k1_record(reads, lengths, group, models, 12, 7))
    padded = torch.nn.functional.pad(reads, (0, 256), value=3)
    b = counts.resolve(counts.k1_record(padded, lengths, group, models, 12, 7))
    assert a == b
    # fewer bases read fewer entries
    c = counts.resolve(counts.k1_record(
        reads, torch.tensor([200, 100, 512], dtype=torch.int32), group,
        models, 12, 7))
    assert c < a


def test_kt_bytes_are_the_scores_and_their_text():
    """KT's count: the float32 matrix read once and its rows' text,
    whose length is that of the plain loop's text."""
    from glimmer_mg_torch.ops.raw_text_cuda import plain_rows

    scores = torch.tensor([[-1.5, 0.0, 12.25], [3.0, -0.00005, 1e6]],
                          dtype=torch.float32)
    text = plain_rows(scores.numpy()).encode("ascii")
    assert text == (b"-1.5000 3.0000\n0.0000 -0.0000\n"
                    b"12.2500 1000000.0000\n")
    rec = counts.kt_record(scores, text)
    assert counts.resolve(rec) == 6 * 4 + len(text) == 24 + 51


@pytest.mark.parametrize("share,seed", [(0.0, 1), (0.5, 3000000019),
                                        (1.0, 7)])
def test_classify_window_keeps_a_seeded_share_of_its_files(tmp_path, share,
                                                           seed):
    """The window keeps for the check a seeded share of the files it
    writes, the first holding the longest read and the last, and deletes
    every other raw matrix and table as soon as it is written."""
    import time
    from types import SimpleNamespace

    from benchmark.ops.classify import Op

    ctx = SimpleNamespace(seed=seed, control=None, traffic={
        "check_file_share": share}, log=lambda m: None)
    op = Op(ctx)
    op.files = [(f"in{i}.fasta", 10) for i in range(3)]
    op.longest_file = 1

    def one_file(src, tag):
        time.sleep(0.01)
        paths = [str(tmp_path / f"{tag}.{x}") for x in ("raw", "tab", "prog")]
        for p in paths:
            with open(p, "w") as fh:
                fh.write(tag)
        return paths

    op._one_file = one_file
    w = op.window(0.2)
    n = w["count"] // 10
    tags = [f"w{k:04d}" for k in range(n)]
    kept = [t for t in tags if (tmp_path / f"{t}.raw").exists()]
    assert [os.path.basename(r).split(".")[0] for _s, r, _t in op.written] \
        == kept
    assert all((tmp_path / f"{t}.tab").exists() == (t in kept)
               for t in tags)
    assert not any((tmp_path / f"{t}.prog").exists() for t in tags)
    draws = np.random.default_rng([seed, 2]).random(n)
    want = {tags[-1], tags[1]} | {t for t, d in zip(tags, draws)
                                  if d < share}
    assert n >= 3 and set(kept) == want
    assert w["bytes_written"] == 2 * sum(len(t) for t in tags)
