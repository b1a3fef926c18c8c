"""PyTorch six-frame ICM walk (glimmer_mg_torch.ops.icm_score) against JAX.

The twin must be BITWISE equal to ``glimmer_mg_tpu.ops.icm_score`` over the
whole (B, 6, L) output, pads included, and to the Pallas kernel (interpret
mode) on every in-read base: its output feeds a byte-compared event DP.
Banks: two trained depth-7 gene ICMs plus a depth-3 one (node padding),
per-model null ICMs of depth 2.
"""

import numpy as np
import pytest
import torch

from glimmer_mg_tpu.models import dna, icm as icm_mod, icm_train
from glimmer_mg_tpu.ops import icm_pallas, icm_score as jis
from glimmer_mg_torch.ops import icm_cuda, icm_score as tis

from tests._torch_common import _gene_like


def _make_bank(seed, depths, b, l):
    rng = np.random.default_rng(seed)
    stops = ("taa", "tag", "tga")
    gene_icms, indeps = [], []
    for k, depth in enumerate(depths):
        gc = 0.35 + 0.1 * k
        seqs = [dna.encode(_gene_like(rng, 200, gc)) for _ in range(12)]
        gene_icms.append(icm_train.train_icm(seqs, model_len=12, depth=depth))
        indeps.append(icm_mod.build_indep_wo_stops(gc, stops))
    gmip, gprobs = jis.stack_bank(gene_icms)
    imip, iprobs = jis.stack_bank(indeps)
    reads = rng.integers(0, 4, (b, l), dtype=np.int32)
    lengths = rng.integers(0, l + 1, b).astype(np.int32)
    lengths[:3] = (l, 3, 0)
    for r, n in enumerate(lengths):
        reads[r, n:] = 0
    group = (np.arange(b) % len(depths)).astype(np.int32)
    return gmip, gprobs, imip, iprobs, reads, lengths, group


@pytest.fixture(scope="module")
def bank():
    """Two depth-7 gene ICMs plus a depth-3 one, null ICMs of depth 2."""
    return _make_bank(3, (7, 7, 3), 7, 384)


def _twin(bank, depth=7):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in bank]
    return tis.mg_six_frame_batch(*t, model_len=12, depth=depth)


def test_stack_bank_matches_jax(bank):
    rng = np.random.default_rng(1)
    icms = [icm_train.train_icm([rng.integers(0, 4, 400).astype(np.int8)],
                                model_len=12, depth=d) for d in (2, 4)]
    for a, b in zip(tis.stack_bank(icms), jis.stack_bank(icms)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("model_len", [3, 12])
def test_pack_contexts_bitwise(model_len):
    rng = np.random.default_rng(model_len)
    seq = rng.integers(0, 4, (3, 50), dtype=np.int32)
    want = np.asarray(jis.pack_contexts(seq, model_len))
    got = tis.pack_contexts(torch.from_numpy(seq), model_len).numpy()
    assert np.array_equal(got, want)


def test_six_frame_twin_bitwise_vs_jax(bank):
    want_g, want_i = jis.mg_six_frame_batch(
        *bank, model_len=12, depth=7, gene_periodicity=3)
    got_g, got_i = _twin(bank)
    assert got_g.dtype == torch.float32 and got_g.shape == (7, 6, 384)
    # bitwise over the whole (B, 6, L) array, pads included
    assert np.array_equal(got_g.numpy().view(np.int32),
                          np.asarray(want_g).view(np.int32))
    assert np.array_equal(got_i.numpy().view(np.int32),
                          np.asarray(want_i).view(np.int32))


def test_six_frame_twin_bitwise_vs_pallas_interpret():
    """The Pallas kernel in interpret mode on a depth-3 bank: at depth 7
    its unrolled table-row scans take ~10 minutes to run on a CPU, so the
    depth-7 equality rests on the XLA walk above, which the JAX package
    holds equal to this kernel."""
    small = _make_bank(9, (3, 3), 5, 128)
    want_g, want_i = icm_pallas.mg_six_frame_pallas(
        *small, model_len=12, depth=3, gene_periodicity=3, interpret=True)
    got_g, got_i = _twin(small, depth=3)
    lengths = small[5]
    for r, n in enumerate(lengths):
        for got, want in ((got_g, want_g), (got_i, want_i)):
            assert np.array_equal(
                got.numpy()[r, :, :n].view(np.int32),
                np.asarray(want)[r, :, :n].view(np.int32)), r


def test_six_frame_matches_host_walk(bank):
    """Rows against the scalar host mirror (models.icm) for one read."""
    gmip, gprobs, imip, iprobs, reads, lengths, group = bank
    got_g, _ = _twin(bank)
    r = 0
    n = int(lengths[r])
    g = int(group[r])
    icm = icm_mod.ICM(12, 7, 3, gmip[g], gprobs[g])
    rev = reads[r, :n][::-1].copy()
    for f in range(3):
        want = icm_mod.per_base_logprob_vec(icm, rev, f, cycle=False)
        assert np.array_equal(got_g.numpy()[r, f, :n], want.astype(np.float32))


def test_wrapper_routes_cpu_tensors_to_twin(bank):
    icm_cuda.reset_launches()
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in bank]
    got_g, got_i = icm_cuda.mg_six_frame(*t, model_len=12, depth=7)
    want_g, want_i = _twin(bank)
    assert torch.equal(got_g, want_g) and torch.equal(got_i, want_i)
    assert icm_cuda.launches == 0  # the twin is not a kernel launch


OUT_OF_RANGE = ["group_high", "group_negative", "length_high",
                "length_negative", "depth_too_deep"]


def out_of_range_call(t, case):
    """Wrapper arguments (list, kwargs) with one index out of range."""
    t, kw = list(t), {"model_len": 12, "depth": 7}
    if case == "group_high":
        t[6] = t[6].clone()
        t[6][1] = t[0].shape[0]
    elif case == "group_negative":
        t[6] = t[6].clone()
        t[6][0] = -1
    elif case == "length_high":
        t[5] = t[5].clone()
        t[5][2] = t[4].shape[1] + 1
    elif case == "length_negative":
        t[5] = t[5].clone()
        t[5][0] = -3
    else:
        kw["depth"] = 8
    return t, kw


@pytest.mark.parametrize("case", OUT_OF_RANGE)
def test_wrapper_rejects_out_of_range_indices(bank, case):
    """The kernel trusts its indices, so the wrapper checks them; the CPU
    route raises the same ValueError before the twin runs."""
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in bank]
    args, kw = out_of_range_call(t, case)
    with pytest.raises(ValueError):
        icm_cuda.mg_six_frame(*args, **kw)


def test_wrapper_rejects_other_devices(bank):
    t = [torch.from_numpy(np.ascontiguousarray(a)).to("meta") for a in bank]
    with pytest.raises(ValueError):
        icm_cuda.mg_six_frame(*t, model_len=12, depth=7)


@pytest.mark.parametrize("case", OUT_OF_RANGE + ["base_high", "mip_high"])
def test_host_checks_reject_out_of_range(bank, case):
    """The prediction engine checks on the host, before the upload, what
    the wrapper's device check rejects, and the bases and mip values the
    kernel trusts: ``check_reads`` on each batch, ``check_tables`` once
    per bank. Its calls then skip the device check (``ranges_checked``)."""
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in bank]
    args, kw = out_of_range_call(t, case)
    gmip, _gp, imip, _ip, reads, lengths, group = [np.array(a.numpy())
                                                   for a in args]
    if case == "base_high":
        reads[0, 0] = 4
    elif case == "mip_high":
        gmip[0, 0, 0] = 16
    with pytest.raises(ValueError):
        icm_cuda.check_tables(gmip, imip, kw["depth"])
        icm_cuda.check_reads(reads, lengths, group, gmip.shape[0])


def test_host_checked_call_equals_twin(bank):
    gmip, _gp, imip, _ip, reads, lengths, group = bank
    icm_cuda.check_tables(gmip, imip, 7)
    icm_cuda.check_reads(reads, lengths, group, gmip.shape[0])
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in bank]
    got = icm_cuda.mg_six_frame(*t, model_len=12, depth=7,
                                ranges_checked=True)
    for a, b in zip(got, _twin(bank)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("frame0", [0, 2])
def test_cumulative_score_matches_jax(bank, frame0):
    """The running total of per-base terms that are bitwise equal to JAX's;
    the sums' order differs (XLA's scan against torch's, which on the CPU
    accumulates in f64), so each side is held within n x 2^-24 x the
    running sum of |terms| of the exact f64 running total."""
    gmip, gprobs, _im, _ip, reads, lengths, _g = bank
    seq = reads[0, :lengths[0]]
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (gmip[0], gprobs[0], seq)]
    terms = tis.per_base_logprob(*t, frame0, 12, 7).numpy()
    assert np.array_equal(terms, np.asarray(jis.per_base_logprob(
        gmip[0], gprobs[0], seq, frame0, 12, 7)))
    want = np.asarray(jis.cumulative_score(gmip[0], gprobs[0], seq, frame0,
                                           12, 7))
    got = tis.cumulative_score(*t, frame0, 12, 7)
    assert got.dtype == torch.float32 and got.shape == want.shape
    exact = np.cumsum(terms.astype(np.float64))
    bound = len(seq) * 2.0 ** -24 * np.cumsum(np.abs(terms.astype(np.float64)))
    for side in (got.numpy(), want):
        assert (np.abs(side - exact) <= bound).all()
