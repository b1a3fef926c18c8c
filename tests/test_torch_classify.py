"""Phymm classification walks of the port (CPU) against the JAX package.

* ``icm_cuda.pack_tables`` equals ``icm_pallas.pack_tables``;
* the bank-walk twin ``icm_score.bank_score_reads_packed`` and the port's
  ``classify_step_kernel`` are BITWISE equal to the Pallas kernel
  ``bank_score_reads_pallas`` in interpret mode (+ revcomp + max), argmax
  identical; ``groups=1, e_block=128`` change only the TPU layout;
* the exact walk: ``per_base_logprob`` bitwise (a table read),
  ``score_string`` and ``classify_step`` within 1e-3 of JAX's f32 sums
  (another summation order), identical argmax where the top-2 margin
  exceeds 1e-2;
* the fixed-point twin within ``length/512`` of the exact f64 walk;
* the kernel wrapper's range checks raise on the CPU route.

Bank: three depth-7 ICMs trained from seeded gene-like sequences, one of
them with 5% of its nodes pruned (mip -2) so walks end on pruned nodes.
"""

import numpy as np
import pytest
import torch

from glimmer_mg_tpu.models import dna, icm as icm_mod, icm_train
from glimmer_mg_tpu.ops import icm_pallas, icm_score as jis
from glimmer_mg_tpu.parallel import classify as jcl
from glimmer_mg_torch.ops import icm_cuda, icm_score as tis
from glimmer_mg_torch.parallel import classify as tcl

from tests._torch_common import BAD, _gene_like, bad_bank_walk_call

LENGTHS = [126, 100, 50, 9, 0, 77]


def _icms(seed=4):
    rng = np.random.default_rng(seed)
    icms = []
    for gc in (0.35, 0.5, 0.62):
        seqs = [dna.encode(_gene_like(rng, 200, gc)) for _ in range(12)]
        icms.append(icm_train.train_icm(seqs, model_len=12, depth=7))
    pruned = icms[2]
    cut = rng.random(pruned.mip.shape) < 0.05
    cut[:, 0] = False
    pruned.mip[cut] = -2
    return icms


@pytest.fixture(scope="module")
def case():
    """Bank tables, reads and the JAX results, computed once."""
    mip, probs = jis.stack_bank(_icms())
    lm, pk = icm_pallas.pack_tables(mip, probs)
    rng = np.random.default_rng(8)
    reads = rng.integers(0, 4, (len(LENGTHS), 126), dtype=np.int32)
    lengths = np.array(LENGTHS, np.int32)
    for r, n in enumerate(lengths):
        reads[r, n:] = 0
    rc = np.asarray(jcl.revcomp_reads(reads, lengths))

    def pallas(r):
        return np.asarray(icm_pallas.bank_score_reads_pallas(
            lm, pk, r, lengths, 12, 7, interpret=True, groups=1,
            e_block=128))

    fwd, rev = pallas(reads), pallas(rc)
    return dict(mip=mip, probs=probs, lm=lm, pk=pk, reads=reads,
                lengths=lengths, rc=rc, fwd=fwd, rev=rev)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def test_pack_tables_matches_jax(case):
    lm, pk = icm_cuda.pack_tables(case["mip"], case["probs"])
    assert lm.dtype == np.int32 and pk.dtype == np.int32
    assert np.array_equal(lm, case["lm"]) and np.array_equal(pk, case["pk"])
    # per-model packing, as PhymmBank does it in chunks, gives the same
    parts = [icm_cuda.pack_tables(case["mip"][i:i + 1],
                                  case["probs"][i:i + 1]) for i in range(3)]
    assert np.array_equal(np.concatenate([p[0] for p in parts]), lm)
    assert np.array_equal(np.concatenate([p[1] for p in parts]), pk)


@pytest.mark.parametrize("strand", ["fwd", "rev"])
def test_bank_walk_twin_bitwise_vs_pallas(case, strand):
    reads = case["reads"] if strand == "fwd" else case["rc"]
    got = tis.bank_score_reads_packed(
        *_t(case["lm"], case["pk"], reads, case["lengths"]), 12, 7)
    assert got.dtype == torch.float32 and got.shape == (len(LENGTHS), 3)
    assert np.array_equal(_bits(got.numpy()), _bits(case[strand]))


def test_classify_step_kernel_bitwise_vs_jax(case):
    icm_cuda.reset_launches()
    scores, best = tcl.classify_step_kernel(
        *_t(case["lm"], case["pk"], case["reads"], case["lengths"]), 12, 7)
    assert icm_cuda.bank_walk_launches == 0  # the CPU route is the twin
    want = np.maximum(case["fwd"], case["rev"])
    assert np.array_equal(_bits(scores.numpy()), _bits(want))
    assert best.dtype == torch.int32
    assert np.array_equal(best.numpy(), np.argmax(want, axis=1))


def test_revcomp_and_pad_reads_match_jax(case):
    got = tcl.revcomp_reads(*_t(case["reads"], case["lengths"]))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), case["rc"])
    seqs = ["acgtn", "", "ttgca" * 7]
    for length in (None, 12):
        for a, b in zip(tcl.pad_reads(seqs, length), jcl.pad_reads(seqs,
                                                                   length)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("cycle,frame0", [(True, 0), (True, 2), (False, 1)])
def test_per_base_logprob_bitwise(case, cycle, frame0):
    seq = case["reads"][0]
    for m in range(3):
        want = jis.per_base_logprob(case["mip"][m], case["probs"][m], seq,
                                    frame0, 12, 7, cycle=cycle)
        got = tis.per_base_logprob(*_t(case["mip"][m], case["probs"][m], seq),
                                   frame0, 12, 7, cycle=cycle)
        assert np.array_equal(_bits(got.numpy()), _bits(want))
    if cycle:  # the f32 total, summed in another order than XLA's
        want = jis.score_string(case["mip"][0], case["probs"][0], seq,
                                frame0, 12, 7)
        got = tis.score_string(*_t(case["mip"][0], case["probs"][0], seq),
                               frame0, 12, 7)
        assert abs(float(got) - float(want)) <= 1e-3


def test_classify_step_exact_vs_jax(case):
    want, want_best = jcl.classify_step(case["mip"], case["probs"],
                                        case["reads"], case["lengths"], 12, 7)
    got, best = tcl.classify_step(
        *_t(case["mip"], case["probs"], case["reads"], case["lengths"]),
        12, 7)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-2
    assert clear.sum() >= 4
    assert np.array_equal(best.numpy()[clear], np.asarray(want_best)[clear])


def test_twin_within_quantization_bound(case):
    """Round-to-nearest 16-bit tables: at most 1/512 per base."""
    icms = [icm_mod.ICM(12, 7, 3, case["mip"][m], case["probs"][m])
            for m in range(3)]
    exact = np.array([[icm_mod.score_string(m, r[:n], 0) for m in icms]
                      for r, n in zip(case["reads"], case["lengths"])])
    got = tis.bank_score_reads_packed(
        *_t(case["lm"], case["pk"], case["reads"], case["lengths"]), 12, 7)
    bound = case["lengths"][:, None] / (2 * icm_cuda.FIXED_SCALE)
    assert (np.abs(got.numpy() - exact) <= bound).all()


@pytest.mark.parametrize("bad", BAD)
def test_wrapper_rejects_out_of_range(case, bad):
    t = _t(case["lm"], case["pk"], case["reads"], case["lengths"])
    args, kw = bad_bank_walk_call(t, bad)
    with pytest.raises(ValueError):
        icm_cuda.bank_score_reads_kernel(*args, **kw)


def test_wrapper_rejects_other_devices(case):
    t = [x.to("meta") for x in _t(case["lm"], case["pk"], case["reads"],
                                  case["lengths"])]
    with pytest.raises(ValueError):
        icm_cuda.bank_score_reads_kernel(*t)
