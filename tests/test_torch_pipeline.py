"""Phymm classification and pipeline stages 1-3 of the port (CPU) against JAX.

* ``parallel.phymm.classify_file`` (the bank-walk twin on the CPU) against
  the JAX package's ``classify_file`` (its exact walk on the CPU) on a
  two-genome database with double ICMs and 30 reads: identical ICM list
  and read ids, scores within ``length/512``, the raw file round-trips;
* ``informative_genomes``, ``running_top_k`` (its streaming-insert quirk
  included) and ``parse_phymm``: identical to the JAX package's;
* ``pipeline.glimmer_mg_pipe.run_pipeline(device="cpu", iterate=0)``, then
  the JAX ``run_pipeline(iterate=0, raw_done=True)`` on a copy of the work
  directory holding the port's raw file: byte-identical ``.class.txt``,
  ``.run1.predict`` and ``.predict``;
* ``iterate >= 1`` and a CUDA request without a GPU raise; the new modules
  import and classify with JAX blocked.
"""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from glimmer_mg_tpu.io.fasta import write_fasta
from glimmer_mg_tpu.parallel import phymm as jphymm
from glimmer_mg_tpu.pipeline import glimmer_mg_pipe as jpipe, train_all
from glimmer_mg_torch.ops import icm_cuda
from glimmer_mg_torch.parallel import phymm as tphymm
from glimmer_mg_torch.pipeline import glimmer_mg_pipe as tpipe

from tests.test_pipeline_mg import _make_genome


@pytest.fixture(scope="module")
def mg_db(tmp_path_factory):
    """The JAX package's pipeline fixture recipe: two genomes (GC 0.33 /
    0.62), double ICMs, 30 reads of 600 bp."""
    root = tmp_path_factory.mktemp("torch_mgdb")
    icm_dir = root / "genomeData"
    rng = np.random.default_rng(11)
    genomes = {"alpha|chrA": _make_genome(rng, 0.33),
               "beta|chrB": _make_genome(rng, 0.62)}
    train_all.train_all(genomes, str(icm_dir), min_icm_bp=2000)
    train_all.double_icms(str(icm_dir))
    reads, truth = [], []
    keys = list(genomes)
    for i in range(30):
        cls = keys[i % 2]
        start = int(rng.integers(0, len(genomes[cls]) - 600))
        reads.append((f"read{i}", genomes[cls][start:start + 600]))
        truth.append(cls.split("|")[0])
    write_fasta(root / "reads.fa", reads, width=60)
    return root, icm_dir, reads, truth


def test_classify_file_vs_jax(mg_db):
    root, icm_dir, reads, truth = mg_db
    out_t, out_j = root / "cls_torch", root / "cls_jax"
    out_t.mkdir()
    out_j.mkdir()
    icm_cuda.reset_launches()
    paths, rids, scores = tphymm.classify_file(
        str(root / "reads.fa"), str(icm_dir), out_dir=str(out_t),
        device="cpu")
    assert icm_cuda.bank_walk_launches == 0
    jpaths, jrids, jscores = jphymm.classify_file(
        str(root / "reads.fa"), str(icm_dir), out_dir=str(out_j))
    assert paths == jpaths and rids == jrids
    assert scores.shape == (30, len(paths)) and scores.dtype == np.float32
    lengths = np.array([len(s) for _h, s in reads], np.float64)[:, None]
    assert (np.abs(scores - np.asarray(jscores)) <= lengths / 512).all()
    best = np.argmax(scores, axis=1)
    got = [tphymm.path_to_genome(paths[b]).split("|")[0] for b in best]
    assert np.mean([g == t for g, t in zip(got, truth)]) >= 0.9
    # the raw file round-trips through the port's reader (and JAX's)
    raw = out_t / tphymm.raw_phymm_name("reads.fa")
    p2, r2, s2 = tphymm.read_raw_phymm_output(raw)
    assert p2 == paths and r2 == rids
    printed = np.array([[float("%.4f" % x) for x in row] for row in scores])
    assert np.array_equal(s2, printed)
    p3, r3, s3 = jphymm.read_raw_phymm_output(raw)
    assert p3 == p2 and r3 == r2 and np.array_equal(s3, s2)
    assert (out_t / "reads_fa_progress.txt").read_text() == "30/30\n"
    assert (out_t / tphymm.results_name("reads.fa")).exists()


def test_exact_route_matches_kernel_route(mg_db):
    """``use_kernel=False`` (the exact f32 walk) against the fixed-point
    route on the same bank: within length/512."""
    root, icm_dir, reads, _truth = mg_db
    bank = tphymm.PhymmBank.from_genome_data(str(icm_dir), "cpu")
    seqs = [s.lower() for _h, s in reads[:8]]
    exact = bank.score_reads(seqs, batch=5, use_kernel=False)
    fixed = bank.score_reads(seqs, batch=5)
    lengths = np.array([len(s) for s in seqs], np.float64)[:, None]
    assert (np.abs(exact - fixed) <= lengths / 512).all()


def test_informative_genomes_matches_jax(mg_db):
    _root, icm_dir, _reads, _truth = mg_db
    got = tpipe.informative_genomes(str(icm_dir))
    assert got == jpipe.informative_genomes(str(icm_dir))
    assert got == {"alpha|chrA", "beta|chrB"}


def _quirk_matrix():
    """A large value left in a late fill slot is pushed out by a later
    column that beats an earlier, smaller slot."""
    return np.array([[-5.0, -9.0, -1.0, -4.0, -8.0],
                     [-1.0, -2.0, -3.0, -0.5, -0.5],
                     [-3.0, -3.0, -3.0, -3.0, -2.0]])


@pytest.mark.parametrize("seed", [None, 0, 1, 2])
def test_running_top_k_matches_jax(seed):
    if seed is None:
        scores = _quirk_matrix()
    else:
        rng = np.random.default_rng(seed)
        scores = np.round(rng.standard_normal((7, 11)) * 2, 1)
    for k in (1, 3, 5):
        got = tpipe.running_top_k(scores, k)
        want = jpipe.running_top_k(scores, k)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    if seed is None:  # the quirk: row 0 drops its best column (2, -1.0)
        assert list(tpipe.running_top_k(scores, 3)[1][0]) == [3, 0, 4]


def test_parse_phymm_matches_jax(tmp_path):
    scores = _quirk_matrix()
    paths = [f"/db/g{k}/nc{k}.icm" for k in range(scores.shape[1])]
    raw = tmp_path / "raw.txt"
    tphymm.write_raw_phymm_output(str(raw), paths, ["r0", "r1", "r2"], scores)
    informative = {"g0|nc0", "g2|nc2", "g3|nc3", "g4|nc4"}
    for k in (1, 3):
        got = tpipe.parse_phymm(str(raw), informative, k)
        assert got == jpipe.parse_phymm(str(raw), informative, k)


def test_pipeline_stages_1_to_3_match_jax(mg_db):
    from glimmer_mg_tpu.utils.observe import StageTimers

    root, icm_dir, reads, _truth = mg_db
    work_t, work_j = root / "pipe_torch", root / "pipe_jax"
    timers = StageTimers()
    final_t = tpipe.run_pipeline(str(root / "reads.fa"), str(icm_dir),
                                 device="cpu", iterate=0,
                                 workdir=str(work_t), timers=timers)
    assert [st.name for st in timers.stages] == ["phymm", "parse_phymm",
                                                 "iter0"]
    assert timers.stages[0].items == len(reads)
    shutil.copytree(work_t, work_j)
    for f in work_j.glob("reads.*"):
        f.unlink()  # keep only the port's raw matrix
    final_j = jpipe.run_pipeline(str(root / "reads.fa"), str(icm_dir),
                                 iterate=0, raw_done=True,
                                 workdir=str(work_j))
    for name in ("reads.class.txt", "reads.run1.predict", "reads.predict"):
        assert (work_t / name).read_bytes() == (work_j / name).read_bytes()
    text = Path(final_t).read_text()
    assert Path(final_j).read_text() == text
    headers = [line[1:] for line in text.splitlines() if line.startswith(">")]
    assert sorted(headers) == sorted(h for h, _ in reads)
    assert sum(1 for line in text.splitlines()
               if line and not line.startswith(">")) > 10


def test_iterate_and_cuda_without_gpu_raise(mg_db):
    root, icm_dir, _reads, _truth = mg_db
    with pytest.raises(NotImplementedError, match="A8"):
        tpipe.run_pipeline(str(root / "reads.fa"), str(icm_dir),
                           device="cpu", iterate=1,
                           workdir=str(root / "pipe_iter"))
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the rest checks a CPU-only machine")
    with pytest.raises(RuntimeError):
        tphymm.PhymmBank.from_genome_data(str(icm_dir), "cuda")
    with pytest.raises(RuntimeError):
        tpipe.run_pipeline(str(root / "reads.fa"), str(icm_dir),
                           device="cuda", workdir=str(root / "pipe_cuda"))


def test_classification_imports_and_runs_without_jax(mg_db):
    """With ``jax`` imports blocked, the classification and pipeline
    modules import and classify on the CPU, loading no JAX-only module."""
    root, icm_dir, _reads, _truth = mg_db
    script = textwrap.dedent(f"""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib"):
                    raise ImportError("jax is blocked")
                return None

        sys.meta_path.insert(0, Block())
        import glimmer_mg_torch.host
        from glimmer_mg_torch.parallel import phymm
        from glimmer_mg_torch.pipeline import glimmer_mg_pipe

        paths, rids, scores = phymm.classify_file(
            {str(root / "reads.fa")!r}, {str(icm_dir)!r},
            out_dir={str(root)!r}, device="cpu")
        assert scores.shape == (30, len(paths)), scores.shape
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib")
               or m.startswith(("glimmer_mg_tpu.ops",
                                "glimmer_mg_tpu.parallel"))]
        assert not bad, bad
        print("OK", len(paths))
    """)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", script], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")
