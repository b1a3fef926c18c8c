"""K2, the Phymm bank-walk CUDA kernel, against its PyTorch twin on the card.

Needs an NVIDIA GPU with nvcc (marker ``cuda``); skipped elsewhere. Run on
a GPU machine with ``python -m pytest tests/test_torch_bank_walk_cuda.py
-q``. The kernel must be BITWISE equal to the twin (on the card and on the
CPU) at small and odd shapes, one strand, both strands in one launch and
8-bit tables: one read, L 3, length 0, banks of 1 and 5 models, pruned
nodes, B not a multiple of the 32 warps of a block and past the 512 reads
of one block, walks shallower than 7 levels; out-of-range arguments must
raise before a launch.
"""

import numpy as np
import pytest
import torch

from glimmer_mg_torch.models import dna, icm_train
from glimmer_mg_torch.ops import icm_cuda, icm_score
from glimmer_mg_torch.parallel import classify

from tests._torch_common import (BAD, _gene_like, bad_bank_walk_call,
                                 former_score_reads, mixed_reads)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(n_models, b, l, seed=2, int8=False, pack_depth=7):
    rng = np.random.default_rng(seed)
    icms = []
    for k in range(n_models):
        seqs = [dna.encode(_gene_like(rng, 150, 0.3 + 0.08 * k))
                for _ in range(8)]
        icm = icm_train.train_icm(seqs, model_len=12, depth=pack_depth)
        if k % 2 == 1:  # prune 5% of the nodes of every other model
            cut = rng.random(icm.mip.shape) < 0.05
            cut[:, 0] = False
            icm.mip[cut] = -2
        icms.append(icm)
    mip, probs = icm_score.stack_bank(icms)
    if int8:
        lm, pk, _scale = icm_cuda.pack_tables_int8(mip, probs, pack_depth)
    else:
        lm, pk = icm_cuda.pack_tables(mip, probs, pack_depth)
    reads = rng.integers(0, 4, (b, l), dtype=np.int32)
    lengths = rng.integers(0, l + 1, b).astype(np.int32)
    lengths[0] = l
    if b > 2:
        lengths[1:3] = (0, min(l, 11))
    for r, n in enumerate(lengths):
        reads[r, n:] = 0
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (lm, pk, reads, lengths)]


def _same(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


SHAPES = [(1, 1, 3), (5, 1, 702), (1, 37, 126), (5, 64, 702), (5, 9, 3),
          (2, 600, 96)]


@pytest.mark.parametrize("n_models,b,l", SHAPES)
@pytest.mark.parametrize("fmt", ["fixed16", "int8"])
def test_kernel_bitwise_equals_twin(cuda, n_models, b, l, fmt):
    int8 = fmt == "int8"
    kw = {"int8": True, "scale": 8.0} if int8 else {}
    cpu = _case(n_models, b, l, int8=int8)
    t = [x.to(cuda) for x in cpu]
    icm_cuda.reset_launches()
    got = icm_cuda.bank_score_reads_kernel(*t, 12, 7, **kw)
    torch.cuda.synchronize()
    assert (icm_cuda.bank_walk_int8_launches, icm_cuda.bank_walk_launches) \
        == ((1, 0) if int8 else (0, 1))
    assert got.shape == (b, n_models) and got.dtype == torch.float32
    want = icm_score.bank_score_reads_packed(*t, 12, 7, **kw)
    assert _same(got, want)
    want_cpu = icm_score.bank_score_reads_packed(*cpu, 12, 7, **kw)
    assert _same(got.cpu(), want_cpu)


@pytest.mark.parametrize("n_models,b,l", SHAPES)
def test_both_strands_bitwise_equals_twin(cuda, n_models, b, l):
    """One launch over both strands equals the max of the twin over the
    reads and their reverse complements, on the card and on the CPU."""
    cpu = _case(n_models, b, l, seed=3)
    t = [x.to(cuda) for x in cpu]
    icm_cuda.reset_launches()
    got = icm_cuda.bank_score_both_strands(*t, 12, 7)
    torch.cuda.synchronize()
    assert icm_cuda.bank_walk_launches == 1
    rc = icm_score.revcomp_reads(t[2], t[3])
    want = torch.maximum(icm_score.bank_score_reads_packed(*t, 12, 7),
                         icm_score.bank_score_reads_packed(t[0], t[1], rc,
                                                           t[3], 12, 7))
    assert _same(got, want)
    assert _same(got.cpu(), icm_cuda.bank_score_both_strands(*cpu, 12, 7))


@pytest.mark.parametrize("pack_depth,depth", [(7, 5), (4, 4), (2, 0)])
@pytest.mark.parametrize("fmt", ["fixed16", "int8"])
def test_shallow_walks_bitwise_equal_twin(cuda, pack_depth, depth, fmt):
    int8 = fmt == "int8"
    kw = {"int8": True, "scale": 8.0} if int8 else {}
    cpu = _case(3, 40, 300, seed=4, int8=int8, pack_depth=pack_depth)
    t = [x.to(cuda) for x in cpu]
    got = icm_cuda.bank_score_both_strands(*t, 12, depth, **kw)
    assert _same(got.cpu(),
                 icm_cuda.bank_score_both_strands(*cpu, 12, depth, **kw))


def test_classify_step_kernel_on_card_matches_cpu(cuda):
    cpu = _case(5, 40, 300)
    gs, gb = classify.classify_step_kernel(*[x.to(cuda) for x in cpu])
    cs, cb = classify.classify_step_kernel(*cpu)
    assert torch.equal(gs.cpu(), cs) and torch.equal(gb.cpu(), cb)


def test_wrapper_checks_types(cuda):
    t = [x.to(cuda) for x in _case(1, 4, 96)]
    bad = list(t)
    bad[2] = t[2].to(torch.int64)
    with pytest.raises(TypeError):
        icm_cuda.bank_score_reads_kernel(*bad)
    bad = list(t)
    bad[2] = t[2].t().contiguous().t()
    with pytest.raises(ValueError):
        icm_cuda.bank_score_reads_kernel(*bad)
    bad = list(t)
    bad[3] = t[3].cpu()
    with pytest.raises(ValueError):
        icm_cuda.bank_score_reads_kernel(*bad)
    bad = list(t)
    bad[2] = t[2].clone()
    bad[2][0, 0] = 4
    with pytest.raises(ValueError):
        icm_cuda.bank_score_both_strands(*bad)


@pytest.mark.parametrize("bad", BAD)
def test_wrapper_rejects_out_of_range(cuda, bad):
    t = [x.to(cuda) for x in _case(1, 4, 96)]
    args, kw = bad_bank_walk_call(t, bad)
    icm_cuda.reset_launches()
    with pytest.raises(ValueError):
        icm_cuda.bank_score_reads_kernel(*args, **kw)
    with pytest.raises(ValueError):
        icm_cuda.bank_score_both_strands(*args, **kw)
    assert icm_cuda.bank_walk_launches == 0


def _bank_dir(path, rng):
    """Three genome ICMs under ``path`` (``<strain>/<nc>.icm``)."""
    from glimmer_mg_torch.models import icm as icm_mod

    for k in range(3):
        seqs = [dna.encode(_gene_like(rng, 150, 0.35 + 0.1 * k))
                for _ in range(8)]
        (path / f"strain{k}").mkdir()
        icm_mod.write_icm(icm_train.train_icm(seqs, model_len=12, depth=7),
                          path / f"strain{k}" / f"NC_{k}.icm")
    return str(path)


@pytest.fixture(scope="module")
def card_bank(cuda, tmp_path_factory):
    from glimmer_mg_torch.parallel import phymm

    root = _bank_dir(tmp_path_factory.mktemp("card_bank"),
                     np.random.default_rng(8))
    return phymm.PhymmBank.from_genome_data(root, cuda)


@pytest.mark.parametrize("n,batch,slab", [(130, 16, 48), (9000, 512, None),
                                          (7, 1, None)])
def test_score_reads_on_card_bitwise_equals_the_per_batch_path(
        card_bank, monkeypatch, n, batch, slab):
    """Slabs encoded and padded on the card, their batches launched back
    to back, against ``pad_reads`` a batch and its upload (the former
    path), and against the CPU twin's ``score_reads``: bitwise, with
    every launch's value check skipped by construction."""
    from glimmer_mg_torch.parallel import phymm
    from glimmer_mg_torch.utils import observe

    if slab is not None:
        monkeypatch.setattr(phymm, "SLAB_READS", slab)
    seqs = mixed_reads(n, n, longest=1100)
    observe.reset()
    observe.enable()
    try:
        got = card_bank.score_reads(seqs, batch=batch)
        counters = observe.snapshot()["counters"]
    finally:
        observe.disable()
        observe.reset()
    want = former_score_reads(card_bank, seqs, batch)
    cpu = phymm.PhymmBank(card_bank.paths, "cpu").score_reads(seqs,
                                                              batch=batch)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(got.view(np.int32), cpu.view(np.int32))
    assert counters["k2_checked_by_construction"] == -(-n // batch)
    assert counters["k2_host_syncs"] == -(-n // phymm._slab_reads(batch))


def test_int8_control_patch_takes_effect(card_bank, monkeypatch):
    """The benchmark's control swaps the bank's tables for 8-bit ones and
    ``classify_step_kernel`` for a step of the same signature that walks
    them: ``score_reads`` then launches the 8-bit walk only, and its
    scores are the former path's under the same patch."""
    b = card_bank
    lm, pk, scale = icm_cuda.pack_tables_int8(b.mip, b.probs, depth=b.depth)

    def step(level_mip, probs_pk, reads, lengths, model_len=12, depth=7):
        return classify._with_best(icm_cuda.bank_score_both_strands(
            level_mip, probs_pk, reads, lengths, model_len, depth,
            int8=True, scale=scale))

    seqs = mixed_reads(4, 70, longest=900)
    plain = b.score_reads(seqs, batch=16)
    monkeypatch.setattr(b, "tables", tuple(
        torch.from_numpy(t).to(b.device) for t in (lm, pk)))
    monkeypatch.setattr(classify, "classify_step_kernel", step)
    icm_cuda.reset_launches()
    got = b.score_reads(seqs, batch=16)
    assert icm_cuda.bank_walk_int8_launches == 5
    assert icm_cuda.bank_walk_launches == 0
    want = former_score_reads(b, seqs, 16)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.array_equal(got, plain)


@pytest.mark.parametrize("bad", ["base_4", "length_past_L"])
def test_direct_calls_check_values_after_a_scope_raised(cuda, bad):
    """A direct call with a base of 4 or a length past L raises, also
    right after a call that raised inside ``values_in_range``."""
    t = [x.to(cuda) for x in _case(1, 4, 96)]
    if bad == "base_4":
        t[2] = t[2].clone()
        t[2][0, 0] = 4
    else:
        t[3] = t[3].clone()
        t[3][1] = t[2].shape[1] + 1
    short = [*t[:2], t[2][:, :-1].contiguous(), t[3].clamp(max=95)]
    icm_cuda.reset_launches()
    with pytest.raises(ValueError, match="multiple of 3"):
        with icm_cuda.values_in_range():
            icm_cuda.bank_score_both_strands(*short)
    for fn in (icm_cuda.bank_score_both_strands,
               icm_cuda.bank_score_reads_kernel):
        with pytest.raises(ValueError, match="lengths must lie"):
            fn(*t)
    assert icm_cuda.bank_walk_launches == 0


def test_score_reads_counts_the_syncs_cuda_reports(cuda, tmp_path):
    """``k2_host_syncs`` over ``PhymmBank.score_reads`` is the number of
    synchronising calls that CUDA's sync debug mode reports there: the
    one slab's download (its upload is from pinned memory, and K2's
    value check is skipped by construction)."""
    import warnings

    from glimmer_mg_torch.parallel import phymm
    from glimmer_mg_torch.utils import observe

    rng = np.random.default_rng(5)
    bank = phymm.PhymmBank.from_genome_data(_bank_dir(tmp_path, rng), cuda)
    reads = [_gene_like(rng, int(rng.integers(20, 200)), 0.5)
             for _ in range(40)]
    bank.score_reads(reads, batch=16)  # builds the kernel
    torch.cuda.synchronize()
    observe.reset()
    observe.enable()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                bank.score_reads(reads, batch=16)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counted = observe.snapshot()["counters"]["k2_host_syncs"]
    finally:
        observe.disable()
        observe.reset()
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert counted == len(syncs) == 1
