"""The raw matrix's DATA rows (``glimmer_mg_torch.ops.raw_text_cuda``) on
the CPU: the wrapper's CPU route (``plain_rows``) gives the bytes of the
writer's former loop, ``" ".join("%.4f" % s for s in scores[:, g])``, on
every class of float32 value the kernel treats apart (exact ties, -0.0
and negatives that round to zero, the carry of x.99996 into the integer
part, both sides of 2^24, huge integers up to FLT_MAX, subnormals, NaN
with either sign and any payload, +-inf) and on float64 matrices; and
``write_raw_phymm_output`` writes the bytes of the plain writer's loops
and of the JAX package's writer. ``test_torch_raw_text_cuda.py`` holds
the kernel to the same values on the card, and its writer's file to the
JAX writer's file committed in ``data/raw_text_golden.npz`` (the card's
machine has no JAX), which ``test_golden_is_the_jax_writers_file`` holds
to that writer here.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from glimmer_mg_torch.ops import raw_text_cuda
from glimmer_mg_torch.parallel import phymm

from tests.test_torch_observe import _plain_raw


def _bits(words):
    return np.array(words, dtype=np.uint32).view(np.float32)


def special_values() -> np.ndarray:
    """float32 values of every class the kernel's text treats apart."""
    f32 = np.float32
    ties = np.arange(-96, 97, dtype=np.float64) / 32  # exact k/32
    near = [0.99995, 0.99996, 9.99996, 99.99996, 999.99996, 0.00005,
            0.00004, 0.00006, 123456.78125, 1048575.96875, 8388607.5]
    big = [2.0 ** 24, 2.0 ** 24 + 2, 1e14, 2.0 ** 63 / 1e4, 2.0 ** 63,
           2.0 ** 64, 2.0 ** 24 * 1e4, 1e30, 2.0 ** 127]
    vals = np.concatenate([
        ties.astype(f32), np.array([-1.03125, 0.03125, 0.0, -0.0, -1e-5,
                                    -0.00005, -4.9e-5, -1e-30, 1e-30],
                                   dtype=f32),
        np.array(near, dtype=f32), -np.array(near, dtype=f32),
        np.array(big, dtype=f32), -np.array(big, dtype=f32),
        np.nextafter(np.array([2.0 ** 24] * 2, dtype=f32),
                     np.array([0, np.inf], dtype=f32)),
        _bits([0x7F7FFFFF, 0xFF7FFFFF,  # +-FLT_MAX
               0x00000001, 0x80000001, 0x007FFFFF, 0x807FFFFF,  # subnormal
               0x00800000, 0x80800000,  # the least normals
               0x4B800000, 0x4B7FFFFF, 0xCB800001,  # around 2^24
               0x7F800000, 0xFF800000,  # +-inf
               0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF,  # NaNs
               0x7FBFFFFF]),
    ])
    # every exponent, with four mantissas and both signs
    rng = np.random.default_rng(19)
    e = np.arange(256, dtype=np.uint32)[:, None] << 23
    m = rng.integers(0, 2 ** 23, size=4).astype(np.uint32)[None, :]
    sweep = (e | m).reshape(-1)
    return np.concatenate([vals, _bits(sweep), _bits(sweep | 0x80000000)])


GOLDEN = Path(__file__).parent / "data" / "raw_text_golden.npz"
GOLDEN_MODELS = 37  # not a multiple of the kernel's 32-model block


def golden_inputs(scores):
    """The ICM paths and read ids the golden file is written with."""
    n, m = scores.shape
    return ([f"/db/strain{k}/nc{k}.icm" for k in range(m)],
            [f"read{i}" for i in range(n)])


def load_golden():
    """(scores, paths, ids, the JAX writer's bytes) of the golden file."""
    with np.load(GOLDEN) as z:
        scores, text = z["scores"], z["text"].tobytes()
    return (scores, *golden_inputs(scores), text)


def write_golden(path=GOLDEN):
    """Writes the golden file: every special value as a float32 matrix of
    GOLDEN_MODELS columns (the last row filled from the start) and the
    JAX package's raw matrix of it. Run with JAX importable."""
    from glimmer_mg_tpu.parallel.phymm import write_raw_phymm_output

    v = special_values()
    n = -(-len(v) // GOLDEN_MODELS)
    scores = np.resize(v, n * GOLDEN_MODELS).reshape(n, GOLDEN_MODELS)
    tmp = Path(path).with_suffix(".txt")
    write_raw_phymm_output(tmp, *golden_inputs(scores), scores)
    text = np.frombuffer(tmp.read_bytes(), dtype=np.uint8)
    tmp.unlink()
    np.savez_compressed(path, scores=scores, text=text)


def loop_rows(scores) -> bytes:
    """The writer's former loop over the rows."""
    return "".join(" ".join("%.4f" % s for s in scores[:, g]) + "\n"
                   for g in range(scores.shape[1])).encode("ascii")


def shapes(values):
    """The values as one column, one row and a ragged block."""
    n = len(values)
    block = np.resize(values, 37 * 23).reshape(37, 23)
    return [values.reshape(n, 1), values.reshape(1, n), block]


def special_as(dtype):
    with np.errstate(invalid="ignore"):  # signalling NaNs stay NaN
        return special_values().astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cpu_route_equals_the_loop(dtype):
    for a in shapes(special_as(dtype)):
        got = raw_text_cuda.rows_text(torch.from_numpy(a))
        assert got == loop_rows(a)


def test_cpu_route_on_log_probabilities_and_empty_shapes():
    rng = np.random.default_rng(3)
    a = (-rng.uniform(200, 1500, size=(300, 41))).astype(np.float32)
    assert raw_text_cuda.rows_text(torch.from_numpy(a)) == loop_rows(a)
    for shape in ((0, 4), (4, 0)):
        a = np.zeros(shape, dtype=np.float32)
        assert raw_text_cuda.rows_text(torch.from_numpy(a)) == loop_rows(a)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_writer_matches_the_plain_writer(tmp_path, dtype):
    from glimmer_mg_tpu.parallel import phymm as jphymm

    scores = np.resize(special_as(dtype), 29 * 31).reshape(29, 31)
    paths = [f"/db/strain{k}/nc{k}.icm" for k in range(31)]
    ids = [f"read{i}" for i in range(29)]
    phymm.write_raw_phymm_output(tmp_path / "raw", paths, ids, scores)
    _plain_raw(tmp_path / "plain", paths, ids, scores)
    jphymm.write_raw_phymm_output(tmp_path / "jax", paths, ids, scores)
    got = (tmp_path / "raw").read_bytes()
    assert got == (tmp_path / "plain").read_bytes()
    assert got == (tmp_path / "jax").read_bytes()


def test_golden_is_the_jax_writers_file(tmp_path):
    from glimmer_mg_tpu.parallel import phymm as jphymm

    scores, paths, ids, text = load_golden()
    assert scores.dtype == np.float32
    bits = special_values().view(np.uint32)
    assert np.isin(bits, scores.view(np.uint32)).all()
    jphymm.write_raw_phymm_output(tmp_path / "jax", paths, ids, scores)
    assert (tmp_path / "jax").read_bytes() == text
    phymm.write_raw_phymm_output(tmp_path / "raw", paths, ids, scores)
    assert (tmp_path / "raw").read_bytes() == text


def test_rows_text_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        raw_text_cuda.rows_text(torch.empty(2, 2, device="meta"))
