"""Scimm clustering of the port (CPU) against the JAX package.

* ``init_clusters_from_results`` (taxonomy ranks, blank ranks, clusters
  dropped under ``minbp_pct``, the all-dropped fallback) and
  ``write_cluster_artifacts``: the same assignment and names, byte-equal
  files;
* the host EM, ``scimm_cluster(use_device=False, device="cpu")``, against
  JAX's ``scimm_cluster(use_device=False)`` on the 2-genome fixture reads
  of tests/test_pipeline_mg.py with a third of the seeds scrambled
  (:124-126): equal assignments, byte-equal ``cluster-<k>.icm``, scores
  within 1e-3 (the exact walk's f32 sums in another order,
  tests/test_torch_classify.py);
* the device EM, ``scimm_cluster(use_device=True, device="cpu")`` (the
  bank trainer, the bank-walk twin over 16-bit tables), against the JAX
  package's TPU branch of ``_device_em``, run on the CPU with
  ``jax.default_backend`` patched to "tpu", the Pallas walk in interpret
  mode (``groups=1, e_block=128`` change only the TPU layout) and
  ``classify_step_pallas`` unjitted: equal assignments and ``mip``,
  logged probs within 8 f32 ulps, scores bitwise equal for each cluster
  whose packed tables are equal;
* ``parallel.classify.em_step`` against JAX's: the same argmax, scores
  within 1e-3, the retrained ``mip`` equal, logged probs within 8 ulps.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from glimmer_mg_tpu.models import dna as jdna, icm as jicm, icm_train
from glimmer_mg_tpu.ops import icm_pallas, icm_score as jis
from glimmer_mg_tpu.parallel import classify as jcl
from glimmer_mg_tpu.pipeline import scimm as jsc
from glimmer_mg_torch.ops import icm_cuda
from glimmer_mg_torch.parallel import classify as tcl
from glimmer_mg_torch.pipeline import scimm as tsc

from tests._torch_common import f32_ulps as _ulps, mg_genomes_and_reads
from tests._torch_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def seeded():
    """The fixture reads and their scrambled seeds."""
    _genomes, reads, _truth = mg_genomes_and_reads()
    seqs = [s for _h, s in reads]
    init = np.array([i % 2 for i in range(len(seqs))], np.int32)
    init[::3] = 1 - init[::3]
    return reads, seqs, init


def _results_file(path, rows):
    with open(path, "w") as fh:
        fh.write("QUERY_ID\tBEST_MATCH\tSCORE\tGENUS\tFAMILY\tORDER\tCLASS"
                 "\tPHYLUM\n")
        for rid, strain, family in rows:
            fh.write(f"{rid}\t{strain}\t-1.0000\tg\t{family}\to\tc\tp\n")


@pytest.mark.parametrize("minbp_pct", [0.0, 0.1, 0.5])
def test_init_clusters_matches_jax(tmp_path, minbp_pct):
    rng = np.random.default_rng(1)
    families = ["famA", "famB", "", "famC"]
    rows = [(f"r{i}", f"s{i % 7}", families[int(rng.integers(4))])
            for i in range(60)]
    path = tmp_path / "results.txt"
    _results_file(path, rows)
    ids = [r[0] for r in rows] + ["unlisted"]
    lengths = rng.integers(100, 700, len(ids))
    got = tsc.init_clusters_from_results(str(path), ids, minbp_pct=minbp_pct,
                                         read_lengths=lengths)
    want = jsc.init_clusters_from_results(str(path), ids,
                                          minbp_pct=minbp_pct,
                                          read_lengths=lengths)
    assert got[1] == want[1] and np.array_equal(got[0], want[0])
    assert got[0].dtype == np.int32
    if minbp_pct == 0.5:  # nothing holds half the bp: one cluster
        assert len(got[1]) == 1 and (got[0] == 0).all()


def test_write_cluster_artifacts_matches_jax(tmp_path, seeded):
    reads, seqs, init = seeded
    icms = tsc._train_cluster_icms(seqs, init, 3)  # cluster 2 is empty
    scores = np.random.default_rng(2).normal(-400, 50, (len(reads), 3))
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tsc.write_cluster_artifacts(str(tmp_path / "t"), reads, init, icms,
                                scores)
    jsc.write_cluster_artifacts(str(tmp_path / "j"), reads, init, icms,
                                scores)
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert len(names) == 9
    for name in names:
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name


def test_host_em_matches_jax(tmp_path, seeded):
    _reads, seqs, init = seeded
    a_t, icms_t, s_t = tsc.scimm_cluster(seqs, init, 2, use_device=False,
                                         device="cpu")
    a_j, icms_j, s_j = jsc.scimm_cluster(seqs, init, 2, use_device=False)
    assert np.array_equal(a_t, a_j)
    assert not np.array_equal(a_t, init)  # the EM moved reads
    for k, (mt, mj) in enumerate(zip(icms_t, icms_j)):
        jicm.write_icm(mt, tmp_path / f"t{k}.icm")
        jicm.write_icm(mj, tmp_path / f"j{k}.icm")
        assert ((tmp_path / f"t{k}.icm").read_bytes()
                == (tmp_path / f"j{k}.icm").read_bytes())
    assert s_t.shape == (len(seqs), 2)
    np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=0, atol=1e-3)


def test_device_em_matches_jax_tpu_branch(seeded):
    _reads, seqs, init = seeded
    a_t, icms_t, s_t = tsc.scimm_cluster(seqs, init, 2, use_device=True,
                                         device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        mp.setattr(icm_pallas, "bank_score_reads_pallas",
                   functools.partial(icm_pallas.bank_score_reads_pallas,
                                     interpret=True, groups=1, e_block=128))
        mp.setattr(jcl, "classify_step_pallas",
                   jcl.classify_step_pallas.__wrapped__)
        a_j, icms_j, s_j = jsc.scimm_cluster(seqs, init, 2, use_device=True)
    assert np.array_equal(a_t, a_j)
    assert not np.array_equal(a_t, init)
    assert len(icms_t) == 2 and icms_t[0].mip.dtype == np.int16
    for mt, mj in zip(icms_t, icms_j):
        assert np.array_equal(mt.mip, mj.mip)
        finite = mj.probs > -3e38
        assert np.array_equal(finite, mt.probs > -3e38)
        assert _ulps(mt.probs[finite], mj.probs[finite]).max() <= 8
    # converged, so the scores come from the returned bank's tables
    tabs = [icm_cuda.pack_tables(np.stack([m.mip for m in icms]),
                                 np.stack([m.probs for m in icms]))
            for icms in (icms_t, icms_j)]
    same = [np.array_equal(tabs[0][1][k], tabs[1][1][k]) for k in range(2)]
    assert any(same)
    s_j = np.asarray(s_j)
    for k in range(2):
        if same[k]:
            assert np.array_equal(s_t[:, k].view(np.int32),
                                  s_j[:, k].view(np.int32))


def test_em_step_matches_jax(seeded):
    _reads, seqs, init = seeded
    icms = [icm_train.train_icm([jdna.encode(s.lower())
                                 for s, a in zip(seqs, init) if a == c])
            for c in range(2)]
    mip, probs = jis.stack_bank(icms)
    reads, lengths = jcl.pad_reads([s.lower() for s in seqs], length=600)
    want = [np.asarray(x) for x in jcl.em_step(mip, probs, reads, lengths,
                                               n_models=2)]
    got = [x.numpy() for x in tcl.em_step(
        *(torch.from_numpy(x) for x in (mip, probs, reads, lengths)),
        n_models=2)]
    new_mip, new_probs, best, scores = got
    assert np.array_equal(best, want[2]) and best.dtype == np.int32
    np.testing.assert_allclose(scores, want[3], rtol=0, atol=1e-3)
    assert np.array_equal(new_mip, want[0])
    finite = want[1] > -3e38
    assert np.array_equal(finite, new_probs > -3e38)
    assert _ulps(new_probs[finite], want[1][finite]).max() <= 8
