"""Device-path parity on long gene-dense reads (glimmer_mg_torch.ops).

Reads of 1.45-2.1 kb, past the JAX package's old packed-sort-key bound:
the event order must stay position-then-family for any padded length.
Same acceptance rule as test_torch_device_predict.py: equal integer
outputs, scores equal at ``%8.2f``, for the f64 and the f32 carry.
"""

import pytest

from tests._torch_common import (  # noqa: F401  (fixture)
    batch_inputs, class_map, long_reads, trained_models,
)
from tests.test_torch_device_predict import assert_outputs_equal, run_pair


@pytest.fixture(scope="module")
def long_batch(trained_models):
    gd, classes = trained_models
    reads = long_reads(53, 12)
    cmap = class_map(reads, classes)
    return batch_inputs(reads, cmap, gd, l_pad=2304, b_pad=64)


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_long_reads_parity(long_batch, f64):
    want, got = run_pair(*long_batch, f64=f64)
    assert_outputs_equal(want, got, f64)
    assert got[8][:12].sum() > 5  # long reads really produced genes
