"""The port's bench fixtures (``glimmer_mg_torch.bench_db``) against the
JAX package's (``glimmer_mg_tpu.bench_db``).

``make_genome``, ``build_bench_db`` (every file of the genomeData tree),
``tile_reads`` and ``bench_reads_and_classes`` must equal the JAX
package's. ``build_sample_run``, the port's synthetic stand-in for the
sample-run, must lay out every file the bench and ``pipeline.accuracy``
read, be deterministic under its seed, and hold the JAX package's own
``run_g3_iterated`` files byte for byte. The JAX functions read the
sample-run at a fixed location; the tests point that at the stand-in
(``tests/_torch_common.py::redirect_jax_sample_run``).
"""

import os
from pathlib import Path

import numpy as np
import pytest

from glimmer_mg_tpu import bench_db as jdb
from glimmer_mg_tpu.pipeline import g3_iterated as jg3
from glimmer_mg_torch import bench_db as tdb
from glimmer_mg_torch.io.fasta import read_fasta

from tests import oracle
from tests._torch_common import (  # noqa: F401 (fixture)
    one_torch_thread, redirect_jax_sample_run, small_sample_run)


def _files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


def _read(root, rel):
    return read_fasta(os.path.join(root, rel))


@pytest.fixture(scope="module")
def stand_in(tmp_path_factory, one_torch_thread):
    return small_sample_run(tmp_path_factory.mktemp("sample_run") / "a")


@pytest.mark.parametrize("gc,n_genes,seed", [(0.39, 4, 3), (0.62, 9, 8)])
def test_make_genome_matches_jax(gc, n_genes, seed):
    want = jdb.make_genome(np.random.default_rng(seed), gc, n_genes=n_genes)
    got = tdb.make_genome(np.random.default_rng(seed), gc, n_genes=n_genes)
    assert got == want and got.isupper()


def test_build_bench_db_matches_jax(tmp_path, one_torch_thread):
    out = {}
    for name, mod in (("jax", jdb), ("torch", tdb)):
        classes, genomes = mod.build_bench_db(tmp_path / name, n_strains=2,
                                              n_genes=10)
        out[name] = classes, genomes, _files(tmp_path / name / "genomeData")
    assert out["torch"][:2] == out["jax"][:2]
    files = out["jax"][2]
    assert any(k.endswith(".gicm") for k in files), list(files)
    assert list(out["torch"][2]) == list(files)
    assert [k for k in files if out["torch"][2][k] != files[k]] == []


def test_sample_run_layout_and_seed(stand_in, tmp_path):
    root, strains = stand_in
    files = _files(root)
    for rel in ("glimmer3/NC_000915.fna", "glimmer-mg/seqs.fa",
                "glimmer3/results/NC_000915.icm",
                "glimmer3/results/NC_000915.run1.predict",
                "glimmer3/results/NC_000915.run2.predict",
                ".sample_run_done"):
        assert rel in files, rel
    header, genome = next(_read(root, "glimmer3/NC_000915.fna"))
    assert "synthetic" in header and genome.isupper()
    reads = list(_read(root, "glimmer-mg/seqs.fa"))
    ids = [h.split()[0] for h, _s in reads]
    assert len(reads) == 30 and len(set(ids)) == 30
    assert all(len(s) == 500 and s.isupper() for _h, s in reads)
    # round-robin over the strains, each read a slice of its strain or of
    # its reverse complement
    comp = str.maketrans("ACGT", "TGCA")
    for i, (h, s) in enumerate(reads):
        g = strains[list(strains)[i % 2]]
        assert h.split()[1].startswith(list(strains)[i % 2])
        assert s in g or s[::-1].translate(comp) in g
    # the same seed writes the same files; another seed other reads
    again, _ = small_sample_run(tmp_path / "again")
    assert _files(again) == files
    other, _ = small_sample_run(tmp_path / "other", seed=12)
    assert _files(other)["glimmer-mg/seqs.fa"] != files["glimmer-mg/seqs.fa"]


def test_half_built_sample_run_builds_again(stand_in, tmp_path):
    root, strains = stand_in
    part = tmp_path / "part"
    (part / "glimmer-mg").mkdir(parents=True)
    (part / "glimmer-mg" / "seqs.fa").write_text(">stale\nACGT\n")
    tdb.build_sample_run(part, strains, seed=11, n_genes=60, n_reads=30)
    assert _files(part) == _files(root)


def test_sample_run_predicts_are_jax_g3_iterated(stand_in, tmp_path,
                                                 monkeypatch):
    root, _strains = stand_in
    monkeypatch.chdir(tmp_path)
    jg3.run_g3_iterated(os.path.join(root, "glimmer3", "NC_000915.fna"),
                        "jax", verbose=False)
    mine = _files(Path(root) / "glimmer3" / "results")
    for suffix in ("icm", "run1.predict", "run2.predict"):
        assert mine[f"NC_000915.{suffix}"] == (tmp_path /
                                               f"jax.{suffix}").read_bytes()


def test_reads_and_classes_and_tiling_match_jax(stand_in, monkeypatch):
    root, _strains = stand_in
    classes = [f"strain{k}|chr" for k in range(3)]
    redirect_jax_sample_run(monkeypatch, root)
    want = jdb.bench_reads_and_classes(classes)
    got = tdb.bench_reads_and_classes(classes, sample_root=root)
    assert got == want and len(got[0]) == 30
    for target in (12, 75):
        assert tdb.tile_reads(*got, target) == jdb.tile_reads(*want, target)


def test_reference_classes_binary_needs_the_reference_sources(tmp_path,
                                                              monkeypatch):
    monkeypatch.setattr(oracle, "REF_SRC", tmp_path / "absent")
    with pytest.raises(RuntimeError, match="reference sources"):
        tdb.build_reference_classes_binary(tmp_path / "db")
