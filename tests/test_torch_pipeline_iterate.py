"""Pipeline stages 4-5 of the port (CPU) against the JAX package.

* ``filter_predictions``, ``keep_start_features_only``, ``_per_read`` and
  ``combine_predictions`` (the ``gene_bp < MIN_GENE_BP`` branch, no
  cluster prediction, and the cluster-vs-classification ratio on both
  sides of ``MIN_CLUST_PHYMM_RATIO``): byte-equal to the JAX package's;
* ``run_pipeline(device="cpu", iterate=1)`` with the host EM
  (``cluster_device=False``) against JAX ``run_pipeline(iterate=1,
  cluster_device=False, raw_done=True)`` on a copy of the port's
  classification files: byte-equal ``cluster-<k>.fa`` and
  ``cluster-<k>.icm``, ``icm-<k>.scores.tmp`` within 1e-3 (the exact
  walk); then JAX resumed with ``clust_done=True`` from the port's cluster
  files: every ``*.cluster-<k>.predict`` and the final ``.predict``
  byte-equal;
* the same with the device EM (``cluster_device=True``): JAX's TPU branch
  of ``scimm_cluster(use_device=True)`` run alone on the CPU, patched as
  in tests/test_torch_scimm.py, its files written by its own
  ``write_cluster_artifacts``: byte-equal ``cluster-<k>.fa`` and
  ``icm-<k>.scores.tmp`` (the bank-walk twin is bitwise equal to the
  Pallas kernel on equal tables); ``cluster-<k>.icm`` with equal ``mip``
  and probs within 8 f32 ulps, as the trainer's own test holds them (the
  trainer logs its probs with each framework's ``log``, and XLA's CPU
  ``log`` is not correctly rounded); then JAX's
  ``run_pipeline(clust_done=True)`` unpatched (its engine reads
  ``jax.default_backend()`` too): every ``.predict`` byte-equal;
* the ``class_done`` resume (``top_scores`` read back from the raw
  matrix) against JAX's;
* ``time_files=True`` writes ``time_reads_<stage>.txt``.

``combine_predictions`` iterates over a set of headers, so its output
order follows the process's string hashes: each comparison runs both
packages in this one process.
"""

import functools
import shutil

import jax
import numpy as np
import pytest

from glimmer_mg_tpu.ops import icm_pallas
from glimmer_mg_tpu.parallel import classify as jcl, phymm as jphymm
from glimmer_mg_tpu.pipeline import glimmer_mg_pipe as jpipe, scimm as jsc
from glimmer_mg_torch.models.icm import read_icm
from glimmer_mg_torch.pipeline import glimmer_mg_pipe as tpipe
from glimmer_mg_torch.utils.observe import StageTimers

from tests._torch_common import f32_ulps as _ulps
from tests._torch_common import mg_db, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PREDICT = (">r1 len=300\n"
           "orf00001      12     290  +1     5.31\n"
           "orf00002     400     310  -2     0.73\n"
           ">r2 len=280\n"
           ">r3 len=310\n"
           "orf00001       3     300  +3     1.00\n"
           "orf00002     303     200  -1    12.50\n")
FEATURES = ("DIST LENGTH\n1 2\n3 4\n"
            "DIST START\nATG 0.8\nGTG 0.1\n"
            "DIST RBS\nAGGAGG 3\n"
            "DIST START fr\nATG 0.7\n")


@pytest.mark.parametrize("filter_t", [-1.0, 1.0, 5.0])
def test_filter_predictions_matches_jax(filter_t):
    got = tpipe.filter_predictions(PREDICT, filter_t)
    assert got == jpipe.filter_predictions(PREDICT, filter_t)
    assert got.count("orf") == {-1.0: 4, 1.0: 2, 5.0: 2}[filter_t]


def test_features_and_per_read_match_jax():
    got = tpipe.keep_start_features_only(FEATURES)
    assert got == jpipe.keep_start_features_only(FEATURES)
    assert got.startswith("DIST START\n") and "RBS" not in got
    assert tpipe._per_read(PREDICT) == jpipe._per_read(PREDICT)
    assert tpipe._per_read(PREDICT)["r2 len=280"] == []


@pytest.mark.parametrize("case", ["small_gene_bp", "no_cluster_text",
                                  "ratio"])
def test_combine_predictions_matches_jax(case):
    clust = PREDICT.replace("5.31", "6.02").replace("12.50", "2.25")
    clust_reads = ["r1 len=300", "r2 len=280", "r3 len=310"]
    lengths = {"r1 len=300": 300, "r2 len=280": 280, "r3 len=310": 310}
    top = {"r1": -400.0, "r2": -380.0, "r3": -420.0}
    # r1 keeps its classification genes (ratio -0.02), r2 and r3 take the
    # cluster's (ratios -0.0125 and 0)
    cscores = {"r1": -406.0, "r2": -383.5, "r3": -420.0}
    gene_bp = {"small_gene_bp": jpipe.MIN_GENE_BP - 1}.get(case, 90000)
    text = None if case == "no_cluster_text" else clust
    args = (PREDICT, text, clust_reads, cscores, top, lengths, gene_bp)
    got = tpipe.combine_predictions(*args)
    assert got == jpipe.combine_predictions(*args)
    assert tpipe.MIN_GENE_BP == jpipe.MIN_GENE_BP
    assert tpipe.MIN_CLUST_PHYMM_RATIO == jpipe.MIN_CLUST_PHYMM_RATIO
    if case == "ratio":
        assert "5.31" in got and "2.25" in got and "12.50" not in got
    else:
        assert got == "".join(f">{h}\n" + "".join(
            f"{r}\n" for r in tpipe._per_read(PREDICT)[h])
            for h in clust_reads)


def _cluster_files(work):
    return sorted(p.name for p in work.glob("cluster-*"))


def _predict_files(work):
    return sorted(p.name for p in work.glob("reads*.predict"))


def _jax_workdir(work_t, dest, keep_clusters):
    """A copy of the port's work directory with the port's classification
    files (and, with ``keep_clusters``, its cluster files) only."""
    shutil.copytree(work_t, dest)
    for f in dest.glob("reads.*"):
        f.unlink()
    if not keep_clusters:
        for f in list(dest.glob("cluster-*")) + list(dest.glob("icm-*")):
            f.unlink()
    return dest


@pytest.fixture(scope="module")
def port_runs(mg_db):
    """The port's iterate=1 pipeline with each EM route: {route: (work
    directory, timers)}."""
    root, icm_dir, _reads, _truth = mg_db
    runs = {}
    for route, cluster_device in (("host", False), ("device", True)):
        work = root / f"iter_{route}"
        timers = StageTimers()
        tpipe.run_pipeline(str(root / "reads.fa"), str(icm_dir),
                           device="cpu", workdir=str(work), timers=timers,
                           cluster_device=cluster_device,
                           time_files=route == "host")
        runs[route] = (work, timers)
    return runs


def _assert_predicts_equal(work_t, work_j):
    names = _predict_files(work_t)
    assert names == _predict_files(work_j)
    assert "reads.predict" in names and any("cluster-" in n for n in names)
    for name in names:
        assert (work_t / name).read_bytes() == (work_j / name).read_bytes(), \
            name


def test_iterate_host_em_matches_jax(mg_db, port_runs):
    root, icm_dir, reads, _truth = mg_db
    work_t, timers = port_runs["host"]
    assert [st.name for st in timers.stages] == [
        "phymm", "parse_phymm", "iter0", "cluster", "repredict"]
    work_j = _jax_workdir(work_t, root / "iter_host_jax", False)
    jpipe.run_pipeline(str(root / "reads.fa"), str(icm_dir), iterate=1,
                       cluster_device=False, raw_done=True,
                       workdir=str(work_j))
    names = _cluster_files(work_t)
    assert names == _cluster_files(work_j) and len(names) == 4
    for name in names:
        assert (work_t / name).read_bytes() == (work_j / name).read_bytes(), \
            name
    for k in range(2):
        got, want = ([float(line.split("\t")[1]) for line in
                      (w / f"icm-{k}.scores.tmp").read_text().splitlines()]
                     for w in (work_t, work_j))
        assert len(got) == len(reads)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    # stage 5 from the port's cluster files
    work_r = _jax_workdir(work_t, root / "iter_host_resume", True)
    jpipe.run_pipeline(str(root / "reads.fa"), str(icm_dir), iterate=1,
                       raw_done=True, clust_done=True, workdir=str(work_r))
    _assert_predicts_equal(work_t, work_r)


def test_iterate_device_em_matches_jax(mg_db, port_runs):
    root, icm_dir, reads, _truth = mg_db
    work_t, _timers = port_runs["device"]
    work_j = _jax_workdir(work_t, root / "iter_device_jax", False)
    seqs = [s for _h, s in reads]
    assign, names = jsc.init_clusters_from_results(
        str(work_j / jphymm.results_name("reads.fa")),
        [h.split()[0] for h, _s in reads], None,
        read_lengths=np.array([len(s) for s in seqs]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        mp.setattr(icm_pallas, "bank_score_reads_pallas",
                   functools.partial(icm_pallas.bank_score_reads_pallas,
                                     interpret=True, groups=1, e_block=128))
        mp.setattr(jcl, "classify_step_pallas",
                   jcl.classify_step_pallas.__wrapped__)
        assign, icms, scores = jsc.scimm_cluster(seqs, assign, len(names),
                                                 use_device=True)
    jsc.write_cluster_artifacts(str(work_j), reads, assign, icms, scores)
    assert _cluster_files(work_j) == _cluster_files(work_t)
    for k in range(2):
        for name in (f"cluster-{k}.fa", f"icm-{k}.scores.tmp"):
            assert ((work_t / name).read_bytes()
                    == (work_j / name).read_bytes()), name
        # the trained probs are logged by each framework's own log
        got, want = (read_icm(w / f"cluster-{k}.icm") for w in (work_t,
                                                                 work_j))
        assert np.array_equal(got.mip, want.mip)
        finite = want.probs > -3e38
        assert np.array_equal(finite, got.probs > -3e38)
        assert _ulps(got.probs[finite], want.probs[finite]).max() <= 8
    jpipe.run_pipeline(str(root / "reads.fa"), str(icm_dir), iterate=1,
                       raw_done=True, clust_done=True, workdir=str(work_j))
    _assert_predicts_equal(work_t, work_j)


def test_class_done_resume_matches_jax(mg_db, port_runs):
    """``class_done`` reads the classes back and takes each read's top
    score from the raw matrix."""
    root, icm_dir, _reads, _truth = mg_db
    work_t0, _timers = port_runs["host"]
    work_t = root / "class_done_port"
    shutil.copytree(work_t0, work_t)
    work_j = root / "class_done_jax"
    shutil.copytree(work_t0, work_j)
    timers = StageTimers()
    tpipe.run_pipeline(str(root / "reads.fa"), str(icm_dir), device="cpu",
                       workdir=str(work_t), class_done=True, clust_done=True,
                       timers=timers)
    assert [st.name for st in timers.stages] == ["iter0", "repredict"]
    jpipe.run_pipeline(str(root / "reads.fa"), str(icm_dir),
                       workdir=str(work_j), class_done=True, clust_done=True)
    _assert_predicts_equal(work_t, work_j)


def test_time_files(port_runs):
    work, timers = port_runs["host"]
    for st in timers.stages:
        text = (work / f"time_reads_{st.name}.txt").read_text()
        assert text == "%.3fs\n" % st.wall_s
    assert (work / "time_reads.txt").read_text().endswith("s\n")
    assert not list(port_runs["device"][0].glob("time_*"))
