"""The port's prediction routes on the CPU, against the JAX package's.

``engine="native"`` runs the port's native C++ engine on six-frame scores
from the six-frame kernel's twin (``precompute="device"``) or on the
engine's own walk (``precompute="host"``). Its ``.predict`` text must be
byte-equal to the JAX package's native route with
``device_precompute=True`` / ``False`` (``GLIMMER_MG_TPU_DEVICE_DP=0``),
and to the port's ``engine="device"`` and ``engine="host"``, in -c and -m
mode, error-free and in substitution mode with and without a quality
file, with the chunk overlap on and off. Also the route counters, a
worker exception re-raised in the caller, and a disabled native engine
raising instead of handing its reads to another route.
"""

import numpy as np
import pytest

from glimmer_mg_tpu.engine import glimmer_mg as jmg
from glimmer_mg_tpu.models import icm as jicm
from glimmer_mg_torch import native as tnative
from glimmer_mg_torch.engine import glimmer_mg as tmg
from glimmer_mg_torch.models import dna

from tests._torch_common import (  # noqa: F401  (fixtures)
    class_map, one_torch_thread, overlap_dense_reads, planted_stop_reads,
    quality_map, trained_models,
)

MODES = ["c", "m"]
ERRORS = ["error_free", "subs", "subs_quality_file"]


def _kw(errors, quals):
    if errors == "error_free":
        return {}
    if errors == "subs":
        return {"allow_subs": True}
    return {"allow_subs": True, "qualities": quals}


@pytest.fixture(scope="module")
def case(trained_models, one_torch_thread):
    """Overlap-dense and planted-stop reads, every third in two classes,
    one unclassified; qualities for two reads in three; the user ICM of
    -m mode."""
    gd, classes = trained_models
    reads = overlap_dense_reads(43, 12) + planted_stop_reads(47, 10)
    cmap = class_map(reads, classes, pair_every=3)
    del cmap[reads[5][0]]
    gicm = jicm.read_icm_cached(gd.classes_icm_file([classes[1]]))
    return gd, reads, cmap, quality_map(reads, 49), gicm


def _args(case, mode):
    gd, reads, cmap, _q, gicm = case
    return (reads, gd, cmap) if mode == "c" else (reads, gicm)


def _jax_native(case, mode, errors, device_precompute):
    """The JAX package's native route (device DP off, native engine on)."""
    fn = jmg.run_glimmer_mg_classes if mode == "c" else jmg.run_glimmer_mg
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GLIMMER_MG_TPU_DEVICE_DP", "0")
        mp.delenv("GLIMMER_MG_TPU_NATIVE", raising=False)
        return jmg.format_predict_mg(fn(
            *_args(case, mode), device_precompute=device_precompute,
            **_kw(errors, case[3])))


@pytest.fixture(scope="module")
def jax_out(case):
    return {(mode, errors, pre): _jax_native(case, mode, errors,
                                             pre == "device")
            for mode in MODES for errors in ERRORS
            for pre in ("device", "host")}


def _port(case, mode, errors, overlap="1", **kw):
    """The port's output text and route counters (overlap on or off)."""
    fn = tmg.run_glimmer_mg_classes if mode == "c" else tmg.run_glimmer_mg
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GLIMMER_MG_TPU_OVERLAP", overlap)
        tmg.reset_counters()
        out = list(fn(*_args(case, mode), device="cpu", chunk_size=8,
                      **_kw(errors, case[3]), **kw))
    return tmg.format_predict_mg(out), dict(tmg.counters)


@pytest.mark.parametrize("precompute", ["device", "host"])
@pytest.mark.parametrize("errors", ERRORS)
@pytest.mark.parametrize("mode", MODES)
def test_native_route_matches_jax(case, jax_out, mode, errors, precompute):
    text, counts = _port(case, mode, errors, engine="native",
                         precompute=precompute)
    assert text == jax_out[mode, errors, precompute]
    n = len(case[2]) if mode == "c" else len(case[1])
    assert counts == {"device_reads": 0, "native_reads": n, "host_reads": 0,
                      "overflow_reads": 0}
    if errors != "error_free":
        assert "S:" in text  # substitution records were really written


@pytest.mark.parametrize("errors", ERRORS)
@pytest.mark.parametrize("mode", MODES)
def test_every_route_and_overlap_agree(case, jax_out, mode, errors):
    """The device DP and the exact host engine give the native route's
    bytes, each with the overlap on and off, and the route counters say
    where the reads went."""
    want = jax_out[mode, errors, "device"]
    assert jax_out[mode, errors, "host"] == want
    n = len(case[2]) if mode == "c" else len(case[1])
    for engine, route in (("device", "device_reads"), ("host", "host_reads"),
                          ("native", "native_reads")):
        for overlap in ("1", "0"):
            text, counts = _port(case, mode, errors, overlap, engine=engine)
            assert text == want, (engine, overlap)
            assert counts[route] + counts["overflow_reads"] == n, counts
            assert sum(counts.values()) - counts["overflow_reads"] == n


def test_worker_exception_reraises(case, monkeypatch):
    """An exception in a chunk's worker half reaches the caller, with the
    overlap on and off, and the earlier chunks' reads were yielded."""
    gd, reads, cmap, _q, gicm = case
    second = dna.encode(reads[8][1])  # the second chunk's first read
    real = tnative.predict_batch

    def flaky(jobs, **kw):
        if np.array_equal(jobs[0][0], second):
            raise OSError("engine fault")
        return real(jobs, **kw)

    monkeypatch.setattr(tnative, "predict_batch", flaky)
    for overlap in ("1", "0"):
        monkeypatch.setenv("GLIMMER_MG_TPU_OVERLAP", overlap)
        got = []
        with pytest.raises(OSError, match="engine fault"):
            for item in tmg.run_glimmer_mg(reads, gicm, device="cpu",
                                           chunk_size=8, engine="native"):
                got.append(item)
        assert len(got) == 8


@pytest.mark.parametrize("precompute", ["device", "host"])
def test_disabled_native_engine_raises(case, monkeypatch, precompute):
    gd, reads, cmap, _q, _gicm = case
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setenv("GLIMMER_MG_TPU_NATIVE", "0")
    tmg.reset_counters()
    with pytest.raises(RuntimeError, match="native engine"):
        list(tmg.run_glimmer_mg_classes(reads[:4], gd, cmap, device="cpu",
                                        engine="native",
                                        precompute=precompute))
    assert sum(tmg.counters.values()) == 0


def test_unknown_route_raises(case):
    gd, reads, cmap, _q, _gicm = case
    for kw in ({"engine": "tpu"}, {"precompute": "cpu"}):
        with pytest.raises(ValueError):
            list(tmg.run_glimmer_mg_classes(reads[:2], gd, cmap,
                                            device="cpu", **kw))
