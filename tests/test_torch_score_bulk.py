"""``PhymmBank.score_reads`` by slabs against the former per-batch path.

``score_reads`` encodes a slab of reads at once (the strings joined,
latin-1, each byte looked up in ``dna.SUBSCRIPT_TABLE`` on the bank's
device), pads it there and walks its batches back to back inside
``icm_cuda.values_in_range``. The former path, rebuilt here, encoded and
padded each batch with ``pclassify.pad_reads`` and called
``classify_step_kernel`` (or ``classify_step`` for the exact walk) on it.
The two must be bitwise equal on the CPU twin: cases, IUPAC codes, bytes
outside the alphabet, empty reads, ragged batches, several slabs. The
value check that the scope skips still guards every direct call.
"""

import numpy as np
import pytest
import torch

from glimmer_mg_torch.models import dna, icm_train
from glimmer_mg_torch.models import icm as icm_mod
from glimmer_mg_torch.ops import icm_cuda
from glimmer_mg_torch.parallel import classify as pclassify
from glimmer_mg_torch.parallel import phymm
from glimmer_mg_torch.utils import observe

from tests._torch_common import (  # noqa: F401
    _gene_like, former_score_reads, mixed_reads, one_torch_thread)


@pytest.fixture(scope="module")
def bank(tmp_path_factory):
    """A three-genome bank on the CPU."""
    root = tmp_path_factory.mktemp("score_bulk")
    rng = np.random.default_rng(7)
    for k in range(3):
        seqs = [dna.encode(_gene_like(rng, 120, 0.35 + 0.1 * k))
                for _ in range(6)]
        (root / f"strain{k}").mkdir()
        icm_mod.write_icm(icm_train.train_icm(seqs, model_len=12, depth=7),
                          root / f"strain{k}" / f"NC_{k}.icm")
    return phymm.PhymmBank.from_genome_data(str(root), "cpu")


def _bitwise(a, b):
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


# (reads, batch, SLAB_READS, use_kernel)
CASES = [(37, 8, None, True),      # n not a multiple of batch, one slab
         (11, 1, None, True),      # a launch a read
         (0, 8, None, True),       # no reads
         (53, 8, 20, True),        # slabs of 16 reads, the last ragged
         (40, 8, 8, True),         # a slab a batch
         (29, 4, 12, False),       # the exact walk takes the same slabs
         (19, 8, None, False)]


@pytest.mark.parametrize("n,batch,slab,use_kernel", CASES)
def test_score_reads_bitwise_equals_the_per_batch_path(
        bank, one_torch_thread, monkeypatch, n, batch, slab,  # noqa: F811
        use_kernel):
    if slab is not None:
        monkeypatch.setattr(phymm, "SLAB_READS", slab)
    seqs = mixed_reads(n + batch, n)
    got = bank.score_reads(seqs, batch=batch, use_kernel=use_kernel)
    want = former_score_reads(bank, seqs, batch, use_kernel)
    assert got.dtype == np.float32 and got.shape == (n, len(bank.paths))
    assert _bitwise(got, want)


def test_case_does_not_change_a_score(bank, one_torch_thread):  # noqa: F811
    seqs = mixed_reads(3, 24)
    assert _bitwise(bank.score_reads([s.upper() for s in seqs], batch=8),
                    bank.score_reads([s.lower() for s in seqs], batch=8))


def test_text_outside_latin1_raises(bank):
    with pytest.raises(UnicodeEncodeError):
        bank.score_reads(["acgtacgt", "acgĀtacgt"], batch=8)
    with pytest.raises(UnicodeEncodeError):
        dna.encode("acgĀtacgt")


def test_slab_rounds_to_whole_batches(monkeypatch):
    monkeypatch.setattr(phymm, "SLAB_READS", 8192)
    assert phymm._slab_reads(512) == 8192
    assert phymm._slab_reads(3000) == 6000
    assert phymm._slab_reads(10000) == 10000
    assert phymm._slab_reads(1) == 8192


def test_score_reads_calls_the_module_step_and_walk(
        bank, one_torch_thread, monkeypatch):  # noqa: F811
    """score_reads looks ``pclassify.classify_step_kernel`` up a call and
    passes it (tables..., reads, lengths, model_len, depth) positionally,
    and that step reaches ``icm_cuda.bank_score_both_strands`` through the
    module: a replacement of either takes effect, as the int8 control's
    does."""
    seqs = mixed_reads(5, 21)
    want = former_score_reads(bank, seqs, 8)
    steps, walks = [], []
    real_step = pclassify.classify_step_kernel
    real_walk = icm_cuda.bank_score_both_strands

    def step(level_mip, probs_pk, reads, lengths, model_len=12, depth=7):
        steps.append((reads.shape, model_len, depth))
        scores, best = real_step(level_mip, probs_pk, reads, lengths,
                                 model_len, depth)
        return scores + 1, best

    def walk(*a, **kw):
        walks.append(a[2].shape)
        return real_walk(*a, **kw)

    monkeypatch.setattr(pclassify, "classify_step_kernel", step)
    monkeypatch.setattr(icm_cuda, "bank_score_both_strands", walk)
    got = bank.score_reads(seqs, batch=8)
    assert len(steps) == len(walks) == 3
    assert steps[0][1:] == (bank.model_len, bank.depth)
    assert np.array_equal(got, want + 1)


def _walk_args(bank, n=4, length=96):
    reads, lengths = pclassify.pad_reads(mixed_reads(1, n, longest=length),
                                         length=length)
    return [*bank.tables, torch.from_numpy(reads), torch.from_numpy(lengths)]


@pytest.mark.parametrize("bad", ["base_4", "length_past_L"])
def test_direct_calls_keep_the_value_check(bank, bad):
    """Outside the scope a bad base or length raises, also right after a
    call that raised inside it; inside it, a bad shape still raises."""
    t = _walk_args(bank)
    if bad == "base_4":
        t[2] = t[2].clone()
        t[2][0, 0] = 4
    else:
        t[3] = t[3].clone()
        t[3][1] = t[2].shape[1] + 1
    short = [*t[:2], t[2][:, :-1].contiguous(), t[3].clamp(max=95)]
    with pytest.raises(ValueError, match="multiple of 3"):
        with icm_cuda.values_in_range():
            icm_cuda.bank_score_both_strands(*short)
    for fn in (icm_cuda.bank_score_both_strands,
               icm_cuda.bank_score_reads_kernel):
        with pytest.raises(ValueError, match="lengths must lie"):
            fn(*t)


def test_scope_skips_the_check_and_counts(bank):
    """Inside the scope a call checks shapes only: no sync counted, one
    ``k2_checked_by_construction``; the scope nests and restores."""
    t = _walk_args(bank)
    observe.reset()
    observe.enable()
    try:
        icm_cuda.bank_score_both_strands(*t)
        with icm_cuda.values_in_range():
            with icm_cuda.values_in_range():
                icm_cuda.bank_score_both_strands(*t)
            icm_cuda.bank_score_reads_kernel(*t)
        icm_cuda.bank_score_reads_kernel(*t)
        counters = observe.snapshot()["counters"]
        names = [s.name for s in observe.snapshot()["spans"]]
    finally:
        observe.disable()
        observe.reset()
    assert counters["k2_host_syncs"] == 2
    assert counters["k2_checked_by_construction"] == 2
    assert names.count("k2.check") == 4


def test_every_code_is_a_base():
    """The slabs skip K2's value check on this: every byte maps to 0..3."""
    from glimmer_mg_torch.io import fasta_share

    for table in (dna.SUBSCRIPT_TABLE, fasta_share._ENC):
        assert len(table) == 256
        assert table.min() >= 0 and table.max() <= 3
