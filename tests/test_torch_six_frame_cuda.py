"""K1, the six-frame ICM walk CUDA kernel, against its PyTorch twin on the card.

Needs an NVIDIA GPU with nvcc (marker ``cuda``); skipped elsewhere. Run
on a GPU machine with ``python -m pytest tests/test_torch_six_frame_cuda.py
-q``. The kernel must be BITWISE equal to the twin over the whole
(B, 6, L) output, pads included, for int16 and int32 mip tables, mixed
lengths, 16 model groups in random row order, with and without prob
tables folded ahead; banks whose walks land on pruned nodes included.
Out-of-range indices and bad folded tables must raise before a launch;
and the slice end to end on the card, error modes included, must give
the CPU run's output.
"""

import numpy as np
import pytest
import torch

from glimmer_mg_torch.ops import icm_cuda, icm_score

from tests.test_torch_icm_score import (
    OUT_OF_RANGE, _make_bank, out_of_range_call,
)
from tests.test_torch_six_frame_fold import _pruned_bank

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def bank16(cuda):
    """16 gene ICMs (12 of depth 7, 4 of depth 3) with null ICMs, four
    banks of four trained from different seeds."""
    parts = [_make_bank(seed, (7, 7, 7, 3), 3, 8)[:4] for seed in range(4)]
    return tuple(np.concatenate(tabs) for tabs in zip(*parts))


def _on(bank, device, mip_dtype=torch.int16):
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in bank]
    t[0] = t[0].to(mip_dtype)
    t[2] = t[2].to(mip_dtype)
    return t


def _reads(seed, b, l, groups):
    """Random reads with lengths L, 3 and 0 first, groups in random order."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, (b, l), dtype=np.int32)
    lengths = rng.integers(0, l + 1, b).astype(np.int32)
    lengths[:3] = (l, 3, 0)[:b]
    for r, n in enumerate(lengths):
        reads[r, n:] = 0
    if isinstance(groups, int):
        group = rng.integers(0, groups, b).astype(np.int32)
    else:
        group = rng.permutation(np.asarray(groups, np.int32))
    return reads, lengths, group


def _check_bitwise(tables, reads, lengths, group, depth=7):
    """The wrapper with and without folded tables (one launch a call),
    bitwise equal to the twin on the card and on the CPU."""
    dev = [torch.from_numpy(a).to(tables[0].device)
           for a in (reads, lengths, group)]
    args = (*tables, *dev)
    tg, ti = icm_score.mg_six_frame_batch(*args, model_len=12, depth=depth)
    if reads.size <= 100_000:  # the twin on the CPU too, where it is quick
        cpu = icm_score.mg_six_frame_batch(*[a.cpu() for a in args],
                                           model_len=12, depth=depth)
        assert torch.equal(tg.cpu(), cpu[0]) and torch.equal(ti.cpu(), cpu[1])
    folded = (icm_cuda.fold_pruned_probs(tables[0], tables[1]),
              icm_cuda.fold_pruned_probs(tables[2], tables[3]))
    runs = {}
    for fold in (None, folded):
        icm_cuda.reset_launches()
        runs[f"wrapper, folded={fold is not None}"] = icm_cuda.mg_six_frame(
            *args, model_len=12, depth=depth, folded=fold)
        torch.cuda.synchronize()
        assert icm_cuda.launches == 1
    for name, (kg, ki) in runs.items():
        assert torch.equal(kg.view(torch.int32), tg.view(torch.int32)), name
        assert torch.equal(ki.view(torch.int32), ti.view(torch.int32)), name


@pytest.mark.parametrize("pruned", [False, True])
@pytest.mark.parametrize("mip_dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("b,l", [(7, 384), (64, 768), (3, 5)])
def test_kernel_bitwise_equals_twin(cuda, mip_dtype, b, l, pruned):
    bank = _make_bank(3, (7, 7, 3), b, l)
    if pruned:  # the same seed's tables, a fifth of their nodes pruned
        bank = _pruned_bank()[:4] + bank[4:]
    _check_bitwise(_on(bank[:4], cuda, mip_dtype), *bank[4:])


@pytest.mark.parametrize("mip_dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("b,l", [(1, 5), (1, 768), (2048, 5), (2048, 96),
                                 (2048, 768)])
def test_kernel_bitwise_16_groups_random_order(cuda, bank16, mip_dtype, b, l):
    _check_bitwise(_on(bank16, cuda, mip_dtype),
                        *_reads(b + l, b, l, 16))


def test_kernel_bitwise_pruned_16_groups(cuda):
    """Walks that land on pruned nodes, 16 groups, B 2,048 x L 768."""
    bank = _pruned_bank()[:4]
    tables = _on(tuple(np.concatenate([a] * 6)[:16] for a in bank), cuda)
    _check_bitwise(tables, *_reads(4, 2048, 768, 16))


def test_kernel_bitwise_uneven_groups(cuda, bank16):
    """Groups of 8 and 32 reads in random order, and one group with a
    single read."""
    groups = np.repeat(np.arange(5), 8).tolist() + [5] * 32 + [15]
    _check_bitwise(_on(bank16, cuda), *_reads(9, len(groups), 96,
                                                   groups))


def test_wrapper_checks_inputs(cuda):
    t = _on(_make_bank(3, (7, 3), 4, 96), cuda)
    bad = list(t)
    bad[4] = t[4].to(torch.int64)
    with pytest.raises(TypeError):
        icm_cuda.mg_six_frame(*bad, model_len=12, depth=7)
    bad = list(t)
    bad[4] = t[4].t().contiguous().t()
    with pytest.raises(ValueError):
        icm_cuda.mg_six_frame(*bad, model_len=12, depth=7)
    bad = list(t)
    bad[5] = t[5].cpu()
    with pytest.raises(ValueError):
        icm_cuda.mg_six_frame(*bad, model_len=12, depth=7)


@pytest.mark.parametrize("case", ["short", "cpu", "float16", "one"])
def test_rejected_launch_raises_and_counts_nothing(cuda, case):
    t = _on(_make_bank(3, (7, 3), 4, 96), cuda)
    folded = [icm_cuda.fold_pruned_probs(t[0], t[1]),
              icm_cuda.fold_pruned_probs(t[2], t[3])]
    kw = {"model_len": 12, "depth": 7}
    if case == "short":
        folded[0] = folded[0][:, :, :-1].contiguous()
    elif case == "cpu":
        folded[1] = folded[1].cpu()
    elif case == "float16":
        folded[0] = folded[0].to(torch.float16)
    else:
        folded = folded[:1]
    icm_cuda.reset_launches()
    with pytest.raises((ValueError, TypeError)):
        icm_cuda.mg_six_frame(*t, folded=tuple(folded), **kw)
    assert icm_cuda.launches == 0


@pytest.mark.parametrize("case", OUT_OF_RANGE)
def test_wrapper_rejects_out_of_range_indices(cuda, case):
    t = _on(_make_bank(3, (7, 3), 4, 96), cuda)
    args, kw = out_of_range_call(t, case)
    icm_cuda.reset_launches()
    with pytest.raises(ValueError):
        icm_cuda.mg_six_frame(*args, **kw)
    assert icm_cuda.launches == 0


def test_slice_on_card_matches_cpu(cuda):
    from glimmer_mg_torch.engine import glimmer_mg as tmg
    from glimmer_mg_torch.models import dna, icm_train

    from tests._torch_common import _gene_like, overlap_dense_reads

    rng = np.random.default_rng(1)
    train = [dna.encode(_gene_like(rng, 150, 0.5)) for _ in range(20)]
    gicm = icm_train.train_icm(train, model_len=12, depth=7)
    reads = overlap_dense_reads(3, 40)
    cpu = list(tmg.run_glimmer_mg(reads, gicm, device="cpu"))
    icm_cuda.reset_launches()
    gpu = list(tmg.run_glimmer_mg(reads, gicm, device=cuda))
    assert icm_cuda.launches > 0
    assert tmg.format_predict_mg(gpu) == tmg.format_predict_mg(cpu)


@pytest.mark.parametrize("mode", ["subs", "subs_quality_file", "indels"])
def test_error_modes_on_card_match_cpu(cuda, mode):
    """Substitution mode (device path, with and without a quality file)
    and indel mode (K1 on the card feeding the native engine) give the
    CPU run's output, with K1 launched."""
    from glimmer_mg_torch.engine import glimmer_mg as tmg
    from glimmer_mg_torch.models import dna, icm_train

    from tests._torch_common import (
        _gene_like, homopolymer_indel_reads, planted_stop_reads,
        quality_map,
    )

    rng = np.random.default_rng(1)
    train = [dna.encode(_gene_like(rng, 150, 0.38)) for _ in range(20)]
    gicm = icm_train.train_icm(train, model_len=12, depth=7)
    if mode == "indels":
        reads = homopolymer_indel_reads(5, 40)
        kw = {"allow_indels": True}
    else:
        reads = planted_stop_reads(6, 40)
        kw = {"allow_subs": True}
        if mode == "subs_quality_file":
            kw["qualities"] = quality_map(reads, 7)
    cpu = list(tmg.run_glimmer_mg(reads, gicm, device="cpu", **kw))
    icm_cuda.reset_launches()
    gpu = list(tmg.run_glimmer_mg(reads, gicm, device=cuda, **kw))
    assert icm_cuda.launches > 0
    assert tmg.format_predict_mg(gpu) == tmg.format_predict_mg(cpu)


@pytest.mark.parametrize("overlap", ["1", "0"])
@pytest.mark.parametrize("mode", ["error_free", "subs_quality_file"])
def test_native_route_on_card_matches_host_precompute(cuda, monkeypatch,
                                                      mode, overlap):
    """``engine="native"`` with K1 on the card (scores packed on the card,
    copied into pinned memory behind an event) gives the bytes of the
    native engine's own walk (``precompute="host"``) and of the device
    route, with K1 launched and every read counted in native_reads."""
    from glimmer_mg_torch.engine import glimmer_mg as tmg
    from glimmer_mg_torch.models import dna, icm_train

    from tests._torch_common import (
        _gene_like, overlap_dense_reads, planted_stop_reads, quality_map,
    )

    monkeypatch.setenv("GLIMMER_MG_TPU_OVERLAP", overlap)
    rng = np.random.default_rng(1)
    train = [dna.encode(_gene_like(rng, 150, 0.38)) for _ in range(20)]
    gicm = icm_train.train_icm(train, model_len=12, depth=7)
    if mode == "error_free":
        reads, kw = overlap_dense_reads(3, 40), {}
    else:
        reads = planted_stop_reads(6, 40)
        kw = {"allow_subs": True, "qualities": quality_map(reads, 7)}
    host = list(tmg.run_glimmer_mg(reads, gicm, device=cuda, engine="native",
                                   precompute="host", chunk_size=16, **kw))
    icm_cuda.reset_launches()
    tmg.reset_counters()
    got = list(tmg.run_glimmer_mg(reads, gicm, device=cuda, engine="native",
                                  chunk_size=16, **kw))
    assert icm_cuda.launches == 3  # one a chunk
    assert tmg.counters["native_reads"] == len(reads)
    want = tmg.format_predict_mg(host)
    assert tmg.format_predict_mg(got) == want
    dp = list(tmg.run_glimmer_mg(reads, gicm, device=cuda, chunk_size=16,
                                 **kw))
    assert tmg.format_predict_mg(dp) == want
