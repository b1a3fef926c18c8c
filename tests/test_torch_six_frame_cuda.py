"""K1, the six-frame ICM walk CUDA kernel, against its PyTorch twin on the card.

Needs an NVIDIA GPU with nvcc (marker ``cuda``); skipped elsewhere. Run
on a GPU machine with ``python -m pytest tests/test_torch_six_frame_cuda.py
-q``. The kernel must be BITWISE equal to the twin over the whole
(B, 6, L) output, pads included, for int16 and int32 mip tables, mixed
lengths and several model groups; out-of-range indices must raise before
a launch; and the slice end to end on the card must give the CPU run's
output.
"""

import numpy as np
import pytest
import torch

from glimmer_mg_torch.ops import icm_cuda, icm_score

from tests.test_torch_icm_score import (
    OUT_OF_RANGE, _make_bank, out_of_range_call,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _on(bank, device, mip_dtype=torch.int16):
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in bank]
    t[0] = t[0].to(mip_dtype)
    t[2] = t[2].to(mip_dtype)
    return t


@pytest.mark.parametrize("mip_dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("b,l", [(7, 384), (64, 768), (3, 5)])
def test_kernel_bitwise_equals_twin(cuda, mip_dtype, b, l):
    bank = _make_bank(3, (7, 7, 3), b, l)
    t = _on(bank, cuda, mip_dtype)
    icm_cuda.reset_launches()
    kg, ki = icm_cuda.mg_six_frame(*t, model_len=12, depth=7)
    torch.cuda.synchronize()
    assert icm_cuda.launches == 1
    tg, ti = icm_score.mg_six_frame_batch(*t, model_len=12, depth=7)
    assert torch.equal(kg.view(torch.int32), tg.view(torch.int32))
    assert torch.equal(ki.view(torch.int32), ti.view(torch.int32))
    cg, _ci = icm_score.mg_six_frame_batch(*_on(bank, "cpu", mip_dtype),
                                           model_len=12, depth=7)
    assert torch.equal(kg.cpu(), cg)


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
    from glimmer_mg_tpu.models import dna, icm_train

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
