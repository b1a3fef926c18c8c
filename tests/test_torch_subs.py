"""Substitution mode on the port's device path, on the CPU, against JAX.

Reads with planted stop codons (``tests/_torch_common.py``), two thirds
of them with a quality file, go through ``glimmer_mg_torch``
(``device="cpu"``, ``allow_subs=True``: six-frame twin, frontend with the
sub-extension families, event DP and traceback on CPU tensors) and
through the JAX package twice: its device path
(GLIMMER_MG_TPU_DEVICE_DP=1) and its exact host engine
(GLIMMER_MG_TPU_DEVICE_DP=0, GLIMMER_MG_TPU_NATIVE=0,
device_precompute=False). Coordinates, ids and (position, type) error
records must be equal read for read, and the ``format_predict_mg`` text
byte-identical to the host engine's, for the f64 and the f32 score
carry, with default qualities and with the quality file; reads past the
device capacity keep their error records. The read set is one JAX
compile shape (120 reads of at most 510 bp). The frontend and -m mode
are in test_torch_subs_frontend.py.
"""

import pytest

from glimmer_mg_tpu.engine import glimmer_mg as jmg
from glimmer_mg_torch.engine import glimmer_mg as tmg
from glimmer_mg_torch.ops import device_predict as tdp

from tests._torch_common import (  # noqa: F401  (fixture)
    class_map, jax_run, planted_stop_reads, quality_map, records,
    sub_genes, trained_models,
)


def assert_same(want, got):
    assert records(want) == records(got)
    assert jmg.format_predict_mg(want) == tmg.format_predict_mg(got)


@pytest.fixture(scope="module")
def subs_case(trained_models):
    """120 reads with planted stops, every third in two classes, a
    quality map; with the JAX host engine's outputs without and with
    it."""
    gd, classes = trained_models
    reads = planted_stop_reads(62, 120)
    cmap = class_map(reads, classes, pair_every=3)
    quals = quality_map(reads, 62)
    host = jax_run(jmg.run_glimmer_mg_classes, reads, gd, cmap,
                   allow_subs=True)
    host_q = jax_run(jmg.run_glimmer_mg_classes, reads, gd, cmap,
                     allow_subs=True, qualities=quals)
    return gd, reads, cmap, quals, host, host_q


def _port_classes(case, **kw):
    gd, reads, cmap = case[:3]
    tmg.reset_counters()
    got = list(tmg.run_glimmer_mg_classes(reads, gd, cmap, device="cpu",
                                          allow_subs=True, **kw))
    c = tmg.counters
    assert c["device_reads"] + c["host_reads"] == len(cmap)
    assert c["host_reads"] == c["overflow_reads"]
    assert c["native_reads"] == 0
    return got


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_subs_classes_mode_matches_jax(subs_case, f64):
    gd, reads, cmap, _q, host, _hq = subs_case
    dev = jax_run(jmg.run_glimmer_mg_classes, reads, gd, cmap, device=True,
                  f64=f64, allow_subs=True)
    got = _port_classes(subs_case, f64=f64)
    assert records(dev) == records(host)
    assert_same(host, got)
    assert sub_genes(host) >= 5  # sub-extended genes were exercised
    assert tmg.counters["device_reads"] > 0


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_subs_quality_file_matches_jax(subs_case, f64):
    gd, reads, cmap, quals, _h, host_q = subs_case
    dev = jax_run(jmg.run_glimmer_mg_classes, reads, gd, cmap, device=True,
                  f64=f64, allow_subs=True, qualities=quals)
    got = _port_classes(subs_case, f64=f64, qualities=quals)
    assert records(dev) == records(host_q)
    assert_same(host_q, got)
    assert sub_genes(host_q) >= 3
    assert tmg.counters["device_reads"] > 0


def test_subs_overflow_keeps_error_records(subs_case, monkeypatch):
    """Reads past a small MAX_EVENTS go to the host engine in subs mode:
    their genes keep their substitution records."""
    monkeypatch.setattr(tdp, "MAX_EVENTS", 12)
    rerun = []
    host_predict = tmg._host_predict

    def spy(jobs, *args, **kw):
        out = host_predict(jobs, *args, **kw)
        rerun.extend(out)
        return out

    monkeypatch.setattr(tmg, "_host_predict", spy)
    got = _port_classes(subs_case)
    assert_same(subs_case[4], got)
    assert tmg.counters["overflow_reads"] == len(rerun) > 0
    # some overflowing read has a sub-extended gene
    assert any(g.errors for genes in rerun for g in genes)
