"""K2, the Phymm bank-walk CUDA kernel, against its PyTorch twin on the card.

Needs an NVIDIA GPU with nvcc (marker ``cuda``); skipped elsewhere. Run on
a GPU machine with ``python -m pytest tests/test_torch_bank_walk_cuda.py
-q``. The kernel must be BITWISE equal to the twin (on the card and on the
CPU) at small and odd shapes: one read, L 3, length 0, banks of 1 and 5
models, pruned nodes; out-of-range arguments must raise before a launch.
"""

import numpy as np
import pytest
import torch

from glimmer_mg_tpu.models import dna, icm_train
from glimmer_mg_torch.ops import icm_cuda, icm_score
from glimmer_mg_torch.parallel import classify

from tests._torch_common import BAD, _gene_like, bad_bank_walk_call

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(n_models, b, l, seed=2):
    rng = np.random.default_rng(seed)
    icms = []
    for k in range(n_models):
        seqs = [dna.encode(_gene_like(rng, 150, 0.3 + 0.08 * k))
                for _ in range(8)]
        icm = icm_train.train_icm(seqs, model_len=12, depth=7)
        if k % 2 == 1:  # prune 5% of the nodes of every other model
            cut = rng.random(icm.mip.shape) < 0.05
            cut[:, 0] = False
            icm.mip[cut] = -2
        icms.append(icm)
    mip, probs = icm_score.stack_bank(icms)
    lm, pk = icm_cuda.pack_tables(mip, probs)
    reads = rng.integers(0, 4, (b, l), dtype=np.int32)
    lengths = rng.integers(0, l + 1, b).astype(np.int32)
    lengths[0] = l
    if b > 2:
        lengths[1:3] = (0, min(l, 11))
    for r, n in enumerate(lengths):
        reads[r, n:] = 0
    return [torch.from_numpy(a) for a in (lm, pk, reads, lengths)]


@pytest.mark.parametrize("n_models,b,l", [(1, 1, 3), (5, 1, 702),
                                          (1, 37, 126), (5, 64, 702),
                                          (5, 9, 3)])
def test_kernel_bitwise_equals_twin(cuda, n_models, b, l):
    cpu = _case(n_models, b, l)
    t = [x.to(cuda) for x in cpu]
    icm_cuda.reset_launches()
    got = icm_cuda.bank_score_reads_kernel(*t, 12, 7)
    torch.cuda.synchronize()
    assert icm_cuda.bank_walk_launches == 1
    assert got.shape == (b, n_models) and got.dtype == torch.float32
    want = icm_score.bank_score_reads_packed(*t, 12, 7)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    want_cpu = icm_score.bank_score_reads_packed(*cpu, 12, 7)
    assert torch.equal(got.cpu().view(torch.int32), want_cpu.view(torch.int32))


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


@pytest.mark.parametrize("bad", BAD)
def test_wrapper_rejects_out_of_range(cuda, bad):
    t = [x.to(cuda) for x in _case(1, 4, 96)]
    args, kw = bad_bank_walk_call(t, bad)
    icm_cuda.reset_launches()
    with pytest.raises(ValueError):
        icm_cuda.bank_score_reads_kernel(*args, **kw)
    assert icm_cuda.bank_walk_launches == 0
