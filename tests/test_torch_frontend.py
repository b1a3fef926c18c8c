"""The error-free frontend against JAX ``_frontend_one``, on the CPU.

``ops.frontend.frontend`` with ``subs`` off is the plain version of KF
(``csrc/frontend.cu``), which the card tests hold to it bit for bit; here
it is held to the JAX package's ``_frontend_one``, jitted on the CPU (the
f32 carry traced without x64, as the JAX package's device path does). The
same padded chunk (random, overlap-dense and start-rich reads, two empty
rows) goes to both with the f64 and the f32 carry, the RBS term on and off
(``W = 0``), and with every start an event (thresholds -1e9), where reads
hold more than MAX_EVENTS candidates. ``n_events`` and the integer fields
of every row (pos, typ, sub, id, trunc), padding rows included, must be
equal; scores of the live rows equal within atol 1e-14 (f64) or 4 ulps
(f32): ``log`` is each framework's own (in the RBS term), every other
operation is in the same order. The wrapper sends CPU tensors to the plain
version and counts no launch.
"""

import jax
import numpy as np
import pytest
import torch

from glimmer_mg_tpu.ops import device_predict as jdp, icm_score as jis
from glimmer_mg_torch.ops import device_predict as tdp, frontend
from glimmer_mg_torch.ops import frontend_cuda

from tests._torch_common import (  # noqa: F401  (fixture)
    batch_inputs, class_map, f32_ulps, overlap_dense_reads, random_reads,
    start_rich_reads, trained_models,
)

EV_INT = ("pos", "typ", "sub", "id", "trunc")
F64_ATOL = 1e-14
F32_ULPS = 4

# name -> (f64 carry, RBS term, thresholds)
CASES = {
    "f64": (True, True, None),
    "f32": (False, True, None),
    "f64_no_rbs": (True, False, None),
    "f32_no_rbs": (False, False, None),
    "f64_every_start": (True, True, -1e9),
}


@pytest.fixture(scope="module")
def chunk(trained_models):
    """One padded chunk (48 x 768, the engine's bucket of reads up to 768
    bp) and its bank and six-frame tables."""
    gd, classes = trained_models
    reads = (random_reads(21, 20, lo=60, hi=500)
             + overlap_dense_reads(22, 12) + start_rich_reads(23, 14))
    cmap = class_map(reads, classes, pair_every=3)
    models_list, seqs, lengths, groups = batch_inputs(
        reads, cmap, gd, l_pad=768, b_pad=48)
    bank = jdp.build_bank(models_list, 768)
    g6, i6 = jis.mg_six_frame_batch(
        bank.gene_mip, bank.gene_probs, bank.indep_mip, bank.indep_probs,
        seqs, lengths, groups, model_len=bank.model_len, depth=bank.depth)
    return (models_list, bank, seqs, lengths, groups, np.array(g6),
            np.array(i6))


def consts_of(bank, rbs, thresh):
    c = dict(min_gene_len=bank.min_gene_len, max_olap=bank.max_olap,
             event_threshold=bank.event_threshold,
             start_threshold=bank.start_threshold, ws=bank.ribosome_window,
             W=bank.pwm_w if rbs else 0, subs=False)
    if thresh is not None:
        c["event_threshold"] = c["start_threshold"] = thresh
    return c


@pytest.fixture(scope="module")
def pairs(chunk):
    """name -> (JAX (ev, n), the port's (ev, n)) as numpy arrays."""
    models_list, bank, seqs, lengths, groups, g6, i6 = chunk
    Lp = seqs.shape[1]
    tbank = tdp.bank_to_device(tdp.build_bank(models_list, 768), "cpu")
    t = torch.from_numpy
    out = {}
    for name, (f64, rbs, thresh) in CASES.items():
        c = consts_of(bank, rbs, thresh)
        with jax.enable_x64(f64):
            run = jax.jit(lambda bj, s, n, gi, a, b: jdp._frontend_one(
                s, n, gi, a, b, bj, Lp, dict(c, f64=f64)))
            want_ev, want_n = run(jdp._bank_jnp(bank), seqs, lengths, groups,
                                  g6, i6)
            want = ({k: np.asarray(v) for k, v in want_ev.items()},
                    np.asarray(want_n))
        fdt = torch.float64 if f64 else torch.float32
        frontend_cuda.reset_launches()
        got_ev, got_n = frontend_cuda.frontend(
            t(seqs), t(lengths), t(groups), t(g6), t(i6), tbank, Lp,
            dict(c, fdt=fdt), tdp.MAX_EVENTS)
        assert frontend_cuda.launches == 0
        out[name] = (want, ({k: v.numpy() for k, v in got_ev.items()},
                            got_n.numpy()))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_error_free_frontend_matches_jax(pairs, name):
    f64, rbs, thresh = CASES[name]
    (want_ev, want_n), (got_ev, got_n) = pairs[name]
    assert np.array_equal(want_n, got_n)
    assert (want_n > 0).sum() >= 25
    if thresh is not None:
        assert (want_n > tdp.MAX_EVENTS).sum() >= 3
    assert (want_n == 0).sum() >= 2
    for k in EV_INT:
        assert np.array_equal(want_ev[k].astype(np.int64),
                              got_ev[k].astype(np.int64)), k
    ne = np.minimum(want_n, tdp.MAX_EVENTS)
    live = np.arange(tdp.MAX_EVENTS)[None, :] < ne[:, None]
    a, b = want_ev["score"][live], got_ev["score"][live]
    assert b.dtype == (np.float64 if f64 else np.float32) == a.dtype
    if f64:
        np.testing.assert_allclose(b, a, rtol=0, atol=F64_ATOL)
    else:
        assert int(f32_ulps(a, b).max()) <= F32_ULPS
    if not rbs:
        # without the RBS term no log is taken: the same bits
        assert np.array_equal(a.view(np.int64 if f64 else np.int32),
                              b.view(np.int64 if f64 else np.int32))


def test_class_sum_is_left_to_right():
    """The mixture's class sum adds left to right (csrc/frontend.cu adds
    in the same order): on values where the order shows, it equals the
    sequential sum, not a pairwise one."""
    seq = torch.zeros((1, 6), dtype=torch.int32)
    C = 4
    cols = torch.zeros((1, C, 1, 4), dtype=torch.float64)
    cols[0, :, 0, 0] = torch.tensor([1.0, 1e-16, 1e-16, 1e-16])
    bank = {"pwm_cols": cols, "pwm_n": torch.tensor([C], dtype=torch.int32),
            "pwm_user": torch.zeros((1, 1, 4), dtype=torch.float64),
            "pwm_is_user": torch.tensor([False]),
            "gc_lp": torch.zeros((1, 4), dtype=torch.float64)}
    pw = frontend._pwm_arrays(seq, torch.zeros(1, dtype=torch.int32), bank, 1,
                              torch.float64)
    seqsum = ((1.0 + 1e-16) + 1e-16) + 1e-16
    assert float(pw["sc_f"][0, 0]) == float(np.log(np.float64(seqsum) / C))
