"""Device-path frontend + event DP (glimmer_mg_torch.ops) against JAX.

On one padded batch and one bank, JAX ``predict_batch_device`` (CPU) and
the port's (CPU) must give EQUAL integer outputs (ids, stops, lengths,
signs, trunc flags, gene counts, event counts with the window-overflow
flag) and scores equal at ``%8.2f``, for the f64 and the f32 score carry.
Scores may differ in the last ulps: prefix sums and ``log`` are each
framework's own. The batch holds random reads and overlap-dense reads
(one JAX compile shape per carry); long reads are in
test_torch_device_predict_long.py. Also: the scans, shifts and gathers
against the JAX helpers, and the bank builder against the JAX one.
"""

import jax
import numpy as np
import pytest
import torch

from glimmer_mg_tpu.ops import device_predict as jdp, icm_score as jis
from glimmer_mg_torch.ops import device_predict as tdp, icm_score as tis

from tests._torch_common import (  # noqa: F401  (fixture)
    batch_inputs, class_map, overlap_dense_reads, random_reads,
    trained_models,
)

OUT_NAMES = ("g_id g_stop g_len g_sign g_trunc g_score g_epos g_etyp cnt "
             "n_flag").split()


def run_pair(models_list, reads, lengths, groups, f64):
    """Both packages' predict_batch_device on the same batch and bank."""
    l_pad = reads.shape[1]
    jbank = jdp.build_bank(models_list, l_pad)
    tbank = tdp.build_bank(models_list, l_pad)
    g6, i6 = jis.mg_six_frame_batch(
        jbank.gene_mip, jbank.gene_probs, jbank.indep_mip, jbank.indep_probs,
        reads, lengths, groups, model_len=jbank.model_len, depth=jbank.depth)
    g6, i6 = np.array(g6), np.array(i6)
    if f64:
        want = jdp.predict_batch_device(jbank, reads, lengths, groups, g6, i6,
                                        f64=True)
    else:
        # the test session enables x64 globally; the JAX f32 carry is the
        # trace without it
        with jax.enable_x64(False):
            want = jdp.predict_batch_device(jbank, reads, lengths, groups,
                                            g6, i6, f64=False)
    dev_bank = tdp.bank_to_device(tbank, "cpu")
    t = torch.from_numpy
    got = tdp.predict_batch_device(tbank, dev_bank, t(reads), t(lengths),
                                   t(groups), t(g6), t(i6), f64=f64)
    return [np.asarray(x) for x in want], got


def assert_outputs_equal(want, got, f64):
    fdt = np.float64 if f64 else np.float32
    for name, a, b in zip(OUT_NAMES, want, got):
        if name == "g_score":
            assert b.dtype == fdt and a.dtype == fdt
            fmt = np.vectorize(lambda x: "%8.2f" % x)
            assert (fmt(a) == fmt(b)).all(), name
        else:
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), name


@pytest.fixture(scope="module")
def mixed_batch(trained_models):
    gd, classes = trained_models
    reads = random_reads(17, 60) + overlap_dense_reads(41, 60)
    cmap = class_map(reads, classes, pair_every=3)
    return batch_inputs(reads, cmap, gd, l_pad=768, b_pad=128)


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_predict_batch_parity(mixed_batch, f64):
    want, got = run_pair(*mixed_batch, f64=f64)
    assert_outputs_equal(want, got, f64)
    cnt, n_flag = got[8], got[9]
    assert cnt[:120].sum() > 40          # genes were really called
    assert (n_flag[:120] > 8).sum() > 10  # and event-dense reads exercised


def test_bank_matches_jax(mixed_batch):
    models_list = mixed_batch[0]
    a = jdp.build_bank(models_list, 768)
    b = tdp.build_bank(models_list, 768)
    for f in a.__dataclass_fields__:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and np.array_equal(va, vb), f
        else:
            assert va == vb, f
    dev = tdp.bank_to_device(b, "cpu")
    assert dev["gene_mip"].dtype == torch.int16
    assert dev["len_score"].dtype == torch.float64
    assert np.array_equal(dev["which_fwd"].numpy(), b.which_fwd)


def _rand_case(seed, dtype=np.int32):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-50, 50, (4, 30)).astype(dtype)
    valid = rng.random((4, 30)) < 0.3
    return vals, valid


@pytest.mark.parametrize("name", ["_cls3_cummax", "_cls3_revcummin",
                                  "_cls3_cumsum"])
def test_cls3_scans_match_jax(name):
    vals, _ = _rand_case(1)
    want = np.asarray(getattr(jdp, name)(vals))
    got = getattr(tdp, name)(torch.from_numpy(vals)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("name", ["_cls3_revfill", "_cls3_fwdfill"])
def test_cls3_fills_match_jax(name):
    vals, valid = _rand_case(2, np.float64)
    wv, wok = map(np.asarray, getattr(jdp, name)(vals, valid))
    gv, gok = getattr(tdp, name)(torch.from_numpy(vals),
                                 torch.from_numpy(valid))
    assert np.array_equal(gok.numpy(), wok)
    # the fill value is defined only where a valid position exists
    assert np.array_equal(gv.numpy()[wok], wv[wok])


@pytest.mark.parametrize("n", [5, 258, 2304])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_prefix_sum_order_matches_jax(n, dtype):
    """The frontend's prefix sums add in the JAX reference's order."""
    from glimmer_mg_torch.ops import frontend

    x = np.random.default_rng(n).normal(size=(2, 3, n)).astype(dtype)
    want = np.asarray(jax.jit(lambda a: jax.numpy.cumsum(a, axis=2))(x))
    got = frontend._blocked_cumsum(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_shifts_and_gathers_match_jax():
    rng = np.random.default_rng(3)
    arr = rng.normal(size=(4, 12))
    arr3 = rng.normal(size=(4, 3, 12))
    idx = rng.integers(-3, 15, (4, 7)).astype(np.int32)
    row = rng.integers(0, 3, (4, 7)).astype(np.int32)
    t = torch.from_numpy
    for k in (1, 5):
        assert np.array_equal(tdp._shift_right(t(arr), k, -1.0).numpy(),
                              np.asarray(jdp._shift_right(arr, k, -1.0)))
        assert np.array_equal(tdp._shift_left(t(arr), k, 7.0).numpy(),
                              np.asarray(jdp._shift_left(arr, k, 7.0)))
    assert np.array_equal(tdp._gather_guard(t(arr), t(idx), -9.0).numpy(),
                          np.asarray(jdp._gather_guard(arr, idx, -9.0)))
    assert np.array_equal(tdp._gather2(t(arr3), t(row), t(idx), 0.5).numpy(),
                          np.asarray(jdp._gather2(arr3, row, idx, 0.5)))
    cols = rng.normal(size=(4, 6))
    ti = rng.integers(0, 6, (4, 9)).astype(np.int32)
    assert np.array_equal(tdp._sel6(t(cols), t(ti)).numpy(),
                          np.asarray(jdp._sel6(cols, ti)))
    assert np.array_equal(tdp._sel3(t(cols[:, :3]), t(ti % 3)).numpy(),
                          np.asarray(jdp._sel3(cols[:, :3], ti % 3)))


def test_six_frame_twin_on_batch(mixed_batch):
    """The DP's six-frame input: the port's twin is bitwise the JAX walk on
    the same bank tables and batch."""
    models_list, reads, lengths, groups = mixed_batch
    bank = tdp.build_bank(models_list, 768)
    dev = tdp.bank_to_device(bank, "cpu")
    t = torch.from_numpy
    got = tis.mg_six_frame_batch(
        dev["gene_mip"], dev["gene_probs"], dev["indep_mip"],
        dev["indep_probs"], t(reads), t(lengths), t(groups),
        model_len=bank.model_len, depth=bank.depth)
    want = jis.mg_six_frame_batch(
        bank.gene_mip, bank.gene_probs, bank.indep_mip, bank.indep_probs,
        reads, lengths, groups, model_len=bank.model_len, depth=bank.depth)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
