"""Substitution mode, continued: the port's frontend against JAX
``_frontend_one``, and -m (user ICM) mode against the JAX package.

The frontend's event tensors for one padded batch of reads with planted
stop codons (``subs=True``, without and with a quality file): integer
fields (pos, typ, id, sub, trunc, err_pos, err_typ) and event counts
exact. ``log`` is each framework's own: in the RBS term (where the
error-free frontend already differs from JAX in the last bits of a few
scores) and, with a quality file, in the stop penalty. So scores are
bitwise equal with default qualities and the RBS term off; with it on,
only start events (the events that carry the RBS boost) may differ, by
at most 1e-14, and the test prints them (``-s``); with a quality file
they are within rtol 1e-12 / atol 1e-12. -m mode: coordinates, ids and error records equal to the JAX
device path and host engine, the ``.predict`` text byte-identical.

Two contracts KF (``csrc/frontend.cu``) implements in substitution mode
are held on the twin here: its two stable argsorts equal one sort of the
valid candidates on (pos, tiekey, concatenation index), the invalid ones
after them in concatenation order, over the 8 Lp + 33 candidates; and the
four no-quality stop penalties KF is given (``stop_penalty_values``) are
the host engine's, and round to ``_stop_penalty``'s values in f64 and f32.
"""

import math

import jax
import numpy as np
import pytest
import torch

from glimmer_mg_tpu.engine import glimmer_mg as jmg
from glimmer_mg_tpu.engine.glimmer_mg import pass_stop_penalty
from glimmer_mg_tpu.models import icm as icm_mod
from glimmer_mg_tpu.ops import device_predict as jdp, icm_score as jis
from glimmer_mg_torch.engine import glimmer_mg as tmg
from glimmer_mg_torch.ops import device_predict as tdp, frontend as tfe

from tests._torch_common import (  # noqa: F401  (fixture)
    batch_inputs, class_map, jax_run, planted_stop_reads, quality_map,
    records, sub_genes, trained_models,
)


@pytest.fixture(scope="module")
def reads_case(trained_models):
    gd, classes = trained_models
    reads = planted_stop_reads(62, 120)
    return gd, classes, reads, quality_map(reads, 62)


def test_subs_user_icm_mode_matches_jax(reads_case):
    """-m mode with the low-GC class's ICM on the low-GC reads, with
    default qualities and with the quality file (which makes the sub
    genes: the default penalty keeps none here)."""
    gd, classes, reads, quals = reads_case
    gicm = icm_mod.read_icm_cached(gd.classes_icm_file([classes[0]]))
    reads = reads[0::2]
    for kw in ({}, {"qualities": quals}):
        host = jax_run(jmg.run_glimmer_mg, reads, gicm, allow_subs=True,
                       **kw)
        dev = jax_run(jmg.run_glimmer_mg, reads, gicm, device=True,
                      allow_subs=True, **kw)
        tmg.reset_counters()
        got = list(tmg.run_glimmer_mg(reads, gicm, device="cpu",
                                      allow_subs=True, **kw))
        assert records(dev) == records(host) == records(got)
        assert jmg.format_predict_mg(host) == tmg.format_predict_mg(got)
        assert tmg.counters["device_reads"] > 0
    assert sub_genes(host) >= 3


@pytest.fixture(scope="module")
def frontend_batch(reads_case):
    """One padded batch (128 x 513) of the reads, its bank, six-frame
    tables and uint8 qualities (255 in rows without a quality file)."""
    gd, classes, reads, quals = reads_case
    cmap = class_map(reads, classes, pair_every=3)
    models_list, seqs, lengths, groups = batch_inputs(reads, cmap, gd,
                                                      l_pad=512, b_pad=128)
    bank = jdp.build_bank(models_list, 512)
    g6, i6 = jis.mg_six_frame_batch(
        bank.gene_mip, bank.gene_probs, bank.indep_mip, bank.indep_probs,
        seqs, lengths, groups, model_len=bank.model_len, depth=bank.depth)
    q = np.full(seqs.shape, 255, np.uint8)
    for r, (h, _s) in enumerate(reads):
        if h in quals:
            q[r, :len(quals[h])] = np.minimum(quals[h], 254)
    # pad the length to a multiple of 3, as predict_batch_device does
    pad = ((0, 0), (0, 1))
    return (models_list, np.pad(seqs, pad), lengths, groups,
            np.pad(np.array(g6), ((0, 0), *pad)),
            np.pad(np.array(i6), ((0, 0), *pad)),
            np.pad(q, pad, constant_values=255))


EV_INT = ("pos", "typ", "id", "sub", "trunc", "err_pos", "err_typ")


@pytest.mark.parametrize("with_quals, rbs", [(False, True), (True, True),
                                              (False, False)],
                         ids=["default_qualities", "quality_file",
                              "default_qualities_no_rbs"])
def test_subs_frontend_matches_jax(frontend_batch, with_quals, rbs):
    models_list, seqs, lengths, groups, g6, i6, q = frontend_batch
    Lp = seqs.shape[1]
    q = q if with_quals else None
    bank = jdp.build_bank(models_list, 512)
    consts = dict(min_gene_len=bank.min_gene_len, max_olap=bank.max_olap,
                  event_threshold=bank.event_threshold,
                  start_threshold=bank.start_threshold,
                  ws=bank.ribosome_window, W=bank.pwm_w if rbs else 0,
                  subs=True)
    run = jax.jit(lambda bj, s, n, gi, a, b, qq: jdp._frontend_one(
        s, n, gi, a, b, bj, Lp, dict(consts, f64=True, qual=with_quals),
        quals=qq))
    want_ev, want_n = run(jdp._bank_jnp(bank), seqs, lengths, groups, g6,
                          i6, q)
    tbank = tdp.build_bank(models_list, 512)
    t = torch.from_numpy
    got_ev, got_n = tfe.frontend(
        t(seqs), t(lengths), t(groups), t(g6), t(i6),
        tdp.bank_to_device(tbank, "cpu"), Lp,
        dict(consts, fdt=torch.float64), tdp.MAX_EVENTS,
        quals=None if q is None else t(q))
    want_n = np.asarray(want_n)
    assert np.array_equal(want_n, got_n.numpy())
    assert (want_n > 0).sum() > 80
    # the events a read holds: its first min(n, MAX_EVENTS) columns
    ne = np.minimum(want_n, tdp.MAX_EVENTS)
    live = np.arange(tdp.MAX_EVENTS)[None, :] < ne[:, None]
    for name in EV_INT:
        a = np.asarray(want_ev[name]).astype(np.int64)[live]
        b = got_ev[name].numpy().astype(np.int64)[live]
        assert np.array_equal(a, b), name
    assert (np.asarray(want_ev["err_typ"])[live] == 2).sum() > 20
    a = np.asarray(want_ev["score"])[live]
    b = got_ev["score"].numpy()[live]
    if with_quals:
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12)
        return
    differ = a != b
    if not rbs:
        assert not differ.any(), int(differ.sum())
        return
    typ = got_ev["typ"].numpy()[live]
    assert np.isin(typ[differ], (tdp.E_FWD_START, tdp.E_REV_START)).all()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-14)
    rows, cols = np.nonzero(live)
    for k in np.flatnonzero(differ):
        r = rows[k]
        print(f"read {r} event {cols[k]}: pos "
              f"{got_ev['pos'][r, cols[k]]} typ {typ[k]} score {b[k]!r} vs "
              f"JAX {a[k]!r}")


@pytest.mark.parametrize("with_quals, rbs", [(False, True), (True, True),
                                              (False, False)],
                         ids=["default_qualities", "quality_file",
                              "default_qualities_no_rbs"])
def test_subs_event_order_is_one_sort(frontend_batch, with_quals, rbs,
                                      monkeypatch):
    """The tie-ordered assembly: every row of the twin's events (all
    8 Lp + 33 of them, padding rows included) is the candidate that one
    sort of the valid candidates on (pos, tiekey, index), followed by the
    invalid ones in index order, puts there."""
    models_list, seqs, lengths, groups, g6, i6, q = frontend_batch
    Lp = seqs.shape[1]
    bank = tdp.build_bank(models_list, 512)
    consts = dict(min_gene_len=bank.min_gene_len, max_olap=bank.max_olap,
                  event_threshold=bank.event_threshold,
                  start_threshold=bank.start_threshold,
                  ws=bank.ribosome_window, W=bank.pwm_w if rbs else 0,
                  subs=True, fdt=torch.float64)
    seen = []
    assemble = tfe._assemble_events

    def spy(fam, max_events, ties=False):
        seen.append(fam)
        return assemble(fam, max_events, ties=ties)

    monkeypatch.setattr(tfe, "_assemble_events", spy)
    t = torch.from_numpy
    width = 8 * Lp + 33
    ev, n_ev = tfe.frontend(
        t(seqs), t(lengths), t(groups), t(g6), t(i6),
        tdp.bank_to_device(bank, "cpu"), Lp, consts, width,
        quals=t(q) if with_quals else None)
    (fam,) = seen

    def cat(key):
        return torch.cat([f[key] for f in fam], dim=-1).numpy()

    valid, pos, tk = cat("valid"), cat("pos"), cat("tiekey")
    assert valid.shape[1] == width
    assert ev["pos"].shape[1] == width
    assert int(tk.max()) < 8 * Lp + 44
    assert (n_ev.numpy() == valid.sum(1)).all()
    idx = np.arange(width)
    fields = {k: cat(k) for k in ("sub", "id", "score", "trunc", "err_pos",
                                  "err_typ")}
    fields["typ"] = np.where(valid, cat("typ"), 0)
    fields["pos"] = pos
    n_sub = n_ties = 0
    for r in range(valid.shape[0]):
        v = valid[r]
        live = idx[v][np.lexsort((idx[v], tk[r, v], pos[r, v]))]
        order = np.concatenate([live, idx[~v]])
        for k, a in fields.items():
            assert np.array_equal(ev[k][r].numpy(), a[r, order],
                                  equal_nan=k == "score"), (r, k)
        n_sub += int((fields["err_typ"][r, live] == 2).sum())
        n_ties += len(live) - len(set(pos[r, live]))
    assert n_sub > 20
    # equal positions occur, so the tie key decides some rows
    assert n_ties > 0


@pytest.mark.parametrize("fdt", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_stop_penalty_values(fdt):
    """KF's four no-quality penalties (the doubles the wrapper passes, at
    2 * mid + last) are the host engine's Pass_Stop_Penalty on each
    strand, and rounded to the carry's type they are ``_stop_penalty``'s
    values with ``quals=None``."""
    vals = tfe.stop_penalty_values()
    assert len(vals) == 4
    for mid in (False, True):
        for last in (False, True):
            m, la = "a" if mid else "c", "a" if last else "c"
            fwd = pass_stop_penalty(None, "t" + m + la, None, 1, 3, 0)
            m, la = "t" if mid else "g", "t" if last else "g"
            rev = pass_stop_penalty(None, la + m + "c", None, -1, 0, 1)
            assert vals[2 * mid + last] == fwd == rev
    mid = torch.tensor([[False, False, True, True]])
    last = torch.tensor([[False, True, False, True]])
    for fwd in (True, False):
        got = tfe._stop_penalty(mid, last, None, fwd, fdt)
        assert got.dtype == fdt
        want = torch.tensor([vals], dtype=torch.float64).to(fdt)
        assert torch.equal(got, want)
    if fdt == torch.float32:
        assert np.array_equal(got[0].numpy(),
                              np.array(vals, dtype=np.float64).astype(
                                  np.float32))
    assert all(math.isfinite(v) and v < 0 for v in vals)
