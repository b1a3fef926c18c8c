"""Indel mode on the port: the six-frame kernel's route feeding the native
engine, on the CPU, against JAX.

Indel chunks take the JAX package's device-precompute route in the port:
six-frame scores from ``icm_cuda.mg_six_frame`` (its twin on CPU tensors)
turned into per-read f64 gene-minus-null tables, then the port's own
native C++ engine (``glimmer_mg_torch.native``). The frame tables must
equal JAX ``device_frame_scores`` bitwise, and the ``.predict`` text of
454-like reads (homopolymer indels; synthesised 454 qualities, and a
quality file) must be byte-identical to the JAX package's exact host
engine, with every read counted in ``native_reads``.
"""

from collections import OrderedDict

import numpy as np
import pytest

from glimmer_mg_tpu.engine import glimmer_mg as jmg
from glimmer_mg_tpu.models import icm as icm_mod
from glimmer_mg_torch import native as tnative
from glimmer_mg_torch.engine import glimmer_mg as tmg
from glimmer_mg_torch.models import dna

from tests._torch_common import (  # noqa: F401  (fixture)
    class_map, homopolymer_indel_reads, jax_run, quality_map, records,
    trained_models,
)


@pytest.fixture(scope="module")
def indel_case(trained_models):
    gd, classes = trained_models
    reads = homopolymer_indel_reads(71, 40)
    cmap = class_map(reads, classes, pair_every=3)
    return gd, reads, cmap, quality_map(reads, 72)


def test_frame_scores_match_jax(indel_case):
    """The route's per-read (6, n) f64 tables equal the JAX package's
    ``device_frame_scores`` on the same Models, bit for bit."""
    gd, reads, cmap, _q = indel_case
    jobs, cache = [], {}
    for h, s in reads:
        key = tuple(cmap[h])
        m = cache.get(key)
        if m is None:
            m = cache[key] = tmg.classes_models(
                list(key), len(s), gd, parsed=None, user_icm=None,
                user_gc=None, user_rbs_pwm=None, user_stop_codons=None,
                fudge_f32=np.float32(1.0), min_gene_len=75,
                max_olap_bases=50, circular=False, icm_cache={})
        jobs.append((dna.encode(s), m, None, False))
    got = tmg._frame_scores_finish(
        tmg._frame_scores_dispatch(jobs, "cpu", OrderedDict()))
    want = jmg.device_frame_scores([(m, s) for s, m, _q, _hq in jobs])
    assert len(got) == len(want) == len(reads)
    for (s, *_r), a, b in zip(jobs, want, got):
        assert b.shape == (6, len(s)) and b.dtype == np.float64
        assert np.array_equal(a.view(np.int64), b.view(np.int64))


def test_frame_bank_rows_are_shared(indel_case):
    """Classes mode makes one Models per (classes, read length), and indels
    make read lengths vary; the route's six-frame bank still holds one row
    per distinct (gene ICM, null ICM), and a chunk with the same rows in
    another order reuses the cached bank and gets the same scores."""
    gd, reads, cmap, _q = indel_case
    jobs, cache = [], {}
    for h, s in reads:
        key = (tuple(cmap[h]), len(s))
        m = cache.get(key)
        if m is None:
            m = cache[key] = tmg.classes_models(
                list(key[0]), len(s), gd, parsed=None, user_icm=None,
                user_gc=None, user_rbs_pwm=None, user_stop_codons=None,
                fudge_f32=np.float32(1.0), min_gene_len=75,
                max_olap_bases=50, circular=False, icm_cache={})
        jobs.append((dna.encode(s), m, None, False))
    rows, models_list, _r, _n, grp = tmg._chunk_batch(jobs, tmg._frame_row,
                                                      "cpu")
    n_classes = len({tuple(cmap[h]) for h, _s in reads})
    assert len(rows) == len(models_list) <= n_classes < len(cache)
    assert int(grp.max()) == len(rows) - 1
    bank_cache = OrderedDict()
    a, b = (tmg._frame_scores_finish(
        tmg._frame_scores_dispatch(j, "cpu", bank_cache))
        for j in (jobs, jobs[::-1]))
    assert len(bank_cache) == 1
    for x, y in zip(a, b[::-1]):
        assert np.array_equal(x.view(np.int64), y.view(np.int64))


@pytest.mark.parametrize("with_quals", [False, True],
                         ids=["454_qualities", "quality_file"])
def test_indel_mode_matches_host_engine(indel_case, with_quals):
    gd, reads, cmap, quals = indel_case
    kw = {"qualities": quals} if with_quals else {}
    host = jax_run(jmg.run_glimmer_mg_classes, reads, gd, cmap, device=False,
                   allow_indels=True, **kw)
    tmg.reset_counters()
    got = list(tmg.run_glimmer_mg_classes(reads, gd, cmap, device="cpu",
                                          allow_indels=True, **kw))
    assert records(host) == records(got)
    assert jmg.format_predict_mg(host) == tmg.format_predict_mg(got)
    c = tmg.counters
    assert c["native_reads"] == len(cmap)
    assert c["host_reads"] == c["device_reads"] == 0
    assert sum(len(g) for _h, g in got) > 20
    # frame shifts were really taken
    assert sum(1 for _h, gs in got for g in gs if g.errors) >= 3


def test_indel_user_icm_mode_matches_host_engine(indel_case, trained_models):
    gd, reads, _cmap, _q = indel_case
    gicm = icm_mod.read_icm_cached(
        gd.classes_icm_file([trained_models[1][1]]))
    host = jax_run(jmg.run_glimmer_mg, reads, gicm, device=False,
                   allow_indels=True)
    tmg.reset_counters()
    got = list(tmg.run_glimmer_mg(reads, gicm, device="cpu",
                                  allow_indels=True, chunk_size=16))
    assert jmg.format_predict_mg(host) == tmg.format_predict_mg(got)
    assert tmg.counters["native_reads"] == len(reads)
    assert tmg.counters["host_reads"] == 0


def test_indel_mode_without_native_engine_raises(indel_case, monkeypatch):
    """With the native engine disabled, an indel call raises with the
    reason instead of slipping onto the Python engine."""
    gd, reads, cmap, _q = indel_case
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setenv("GLIMMER_MG_TPU_NATIVE", "0")
    tmg.reset_counters()
    with pytest.raises(RuntimeError, match="native engine"):
        list(tmg.run_glimmer_mg_classes(reads[:4], gd, cmap, device="cpu",
                                        allow_indels=True))
    assert tmg.counters["host_reads"] == 0
