"""The raw-text kernel (``csrc/raw_text.cu``) against its plain version on
the card.

Needs an NVIDIA GPU with nvcc (marker ``cuda``); skipped elsewhere. Run
on a GPU machine with ``python -m pytest tests/test_torch_raw_text_cuda.py
-q`` (under 2 minutes, most of it the plain version's Python loop). The
kernel's bytes must equal ``raw_text_cuda.plain_rows`` on every class of
float32 value (``test_torch_raw_text.special_values``: exact ties k/32,
-0.0, negatives that round to "-0.0000", -0.00005 as float32, which is
just above -0.00005 and prints "-0.0000", the carry of x.99996, values
around 2^24, 1e14 and 2^63 / 1e4, FLT_MAX, subnormals, NaN and +-inf),
on 2^24 random bit patterns, on 1 read and 1 model, on shapes that are
not multiples of the kernel's 256-read tile or 32-model block, and on a
16,384 x 539 matrix of log-probability-sized values. The writer's file
on the CUDA route equals its CPU route's and, on the special values,
the JAX package's writer's file (``data/raw_text_golden.npz``, held to
that writer on the CPU by ``test_torch_raw_text.py``); each written
matrix counts one launch, and a matrix that is not a contiguous 2-D
float32 one raises before a launch.
"""

import numpy as np
import pytest
import torch

from glimmer_mg_torch.ops import raw_text_cuda
from glimmer_mg_torch.parallel import phymm

from tests.test_torch_raw_text import load_golden, shapes, special_values

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def logprobs():
    """16,384 reads x 539 ICMs of classification-sized scores."""
    rng = np.random.default_rng(1902)
    return (-rng.uniform(250.0, 1600.0, size=(16384, 539))).astype(np.float32)


def kernel_bytes(a, device):
    """The kernel's text of the numpy matrix ``a``, one counted launch."""
    before = raw_text_cuda.launches
    got = bytes(raw_text_cuda.rows_text(torch.from_numpy(a).to(device)))
    assert raw_text_cuda.launches == before + (a.size > 0)
    return got


def assert_same(a, device):
    got = kernel_bytes(a, device)
    want = raw_text_cuda.plain_rows(a).encode("ascii")
    if got != want:
        k = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y),
                 min(len(got), len(want)))
        raise AssertionError(f"{a.shape}: {len(got)} / {len(want)} bytes, "
                             f"first difference at {k}: "
                             f"{got[k - 30:k + 30]!r} / {want[k - 30:k + 30]!r}")


@pytest.mark.parametrize("shape", ["column", "row", "block"])
def test_special_values(cuda, shape):
    a = dict(zip(["column", "row", "block"], shapes(special_values())))[shape]
    assert_same(np.ascontiguousarray(a), cuda)


def test_random_bit_patterns(cuda):
    rng = np.random.default_rng(24)
    for _ in range(4):  # 2^24 values in four matrices
        words = rng.integers(0, 2 ** 32, size=(2 ** 16, 64), dtype=np.uint64)
        assert_same(words.astype(np.uint32).view(np.float32), cuda)


@pytest.mark.parametrize("shape", [(1, 1), (1, 539), (16384, 1), (255, 31),
                                   (257, 33), (1000, 45), (8193, 65),
                                   (3, 1100), (0, 5), (5, 0)])
def test_shapes(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    a = (rng.normal(size=shape) * 10.0 ** rng.integers(-5, 9, size=shape))
    assert_same(a.astype(np.float32), cuda)


def test_log_probability_matrix(cuda, logprobs):
    assert_same(logprobs, cuda)


def test_writer_cuda_route_equals_cpu_route(cuda, logprobs, tmp_path,
                                            monkeypatch):
    scores = logprobs[:2048, :101].copy()
    scores[0, :5] = [-0.0, 1 / 32, -0.00005, np.nan, -np.inf]
    paths = [f"/db/strain{k}/nc{k}.icm" for k in range(101)]
    ids = [f"read{i}" for i in range(2048)]
    before = raw_text_cuda.launches
    for k in range(2):
        phymm.write_raw_phymm_output(tmp_path / f"cuda{k}", paths, ids,
                                     scores)
        assert raw_text_cuda.launches == before + k + 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    phymm.write_raw_phymm_output(tmp_path / "cpu", paths, ids, scores)
    assert raw_text_cuda.launches == before + 2
    want = (tmp_path / "cpu").read_bytes()
    assert (tmp_path / "cuda0").read_bytes() == want
    assert (tmp_path / "cuda1").read_bytes() == want


def test_writer_cuda_route_equals_the_jax_writers_file(cuda, tmp_path):
    scores, paths, ids, text = load_golden()
    before = raw_text_cuda.launches
    phymm.write_raw_phymm_output(tmp_path / "cuda", paths, ids, scores)
    assert raw_text_cuda.launches == before + 1
    assert (tmp_path / "cuda").read_bytes() == text


def test_bad_inputs_raise_before_a_launch(cuda):
    a = torch.zeros(64, 8, device=cuda)
    before = raw_text_cuda.launches
    for bad, err in ((a.double(), TypeError), (a.half(), TypeError),
                     (a[:, 0], ValueError), (a[None], ValueError),
                     (a.t(), ValueError), (a[:, ::2], ValueError)):
        with pytest.raises(err):
            raw_text_cuda.rows_text(bad)
    assert raw_text_cuda.launches == before
