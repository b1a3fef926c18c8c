"""The port's slice end to end: glimmer_mg_torch.engine.glimmer_mg on the CPU.

``run_glimmer_mg_classes`` (-c) and ``run_glimmer_mg`` (-m) through the
device path (six-frame twin, frontend, event DP, traceback on CPU tensors)
against the JAX package's exact host engine (GLIMMER_MG_TPU_DEVICE_DP=0,
GLIMMER_MG_TPU_NATIVE=0, device_precompute=False): coordinates identical
read for read and ``format_predict_mg`` text byte-identical. Also the
routing counters, the overflow route to the host engine, the import
without JAX, and that a CUDA request without a GPU raises.
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from glimmer_mg_tpu.engine import glimmer_mg as jmg
from glimmer_mg_tpu.models import icm as icm_mod
from glimmer_mg_torch.engine import glimmer_mg as tmg
from glimmer_mg_torch.ops import device_predict as tdp, icm_cuda

from tests._torch_common import (  # noqa: F401  (fixture)
    class_map, coords, long_reads, overlap_dense_reads, random_reads,
    trained_models,
)

HOST_ENV = {"GLIMMER_MG_TPU_DEVICE_DP": "0", "GLIMMER_MG_TPU_NATIVE": "0"}


def _host(fn, *args, **kw):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in HOST_ENV.items():
            mp.setenv(k, v)
        return list(fn(*args, device_precompute=False, **kw))


@pytest.fixture(scope="module")
def classes_case(trained_models):
    """Random, overlap-dense and long reads, every third read in two
    classes, a few unclassified reads; with the host engine's output."""
    gd, classes = trained_models
    reads = (random_reads(17, 80, lo=60) + overlap_dense_reads(41, 60)
             + long_reads(53, 6))
    cmap = class_map(reads, classes, pair_every=3)
    for h, _s in reads[::20]:
        del cmap[h]
    host = _host(jmg.run_glimmer_mg_classes, reads, gd, cmap)
    return gd, reads, cmap, host


def _assert_same(host, got):
    assert [h for h, _ in host] == [h for h, _ in got]
    for (h, hg), (_g, gg) in zip(host, got):
        assert coords(hg) == coords(gg), h
    assert jmg.format_predict_mg(host) == tmg.format_predict_mg(got)


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_classes_mode_matches_host_engine(classes_case, f64):
    gd, reads, cmap, host = classes_case
    tmg.reset_counters()
    got = list(tmg.run_glimmer_mg_classes(reads, gd, cmap, device="cpu",
                                          f64=f64))
    _assert_same(host, got)
    n_cls = len(cmap)
    assert sum(len(g) for _h, g in got) > 20  # genes were really called
    # unclassified reads are never emitted (classes emission order)
    assert len(got) == n_cls
    c = tmg.counters
    assert c["device_reads"] + c["host_reads"] == n_cls
    assert c["host_reads"] == c["overflow_reads"]


def test_unclassified_reads_yield_empty(trained_models):
    """A classified read list with the classes map missing some reads in
    user-ICM classes mode: unclassified reads yield []."""
    gd, classes = trained_models
    reads = random_reads(5, 6, lo=200)
    cmap = {h: [classes[0]] for h, _s in reads[:3]}
    gicm = icm_mod.read_icm_cached(gd.classes_icm_file([classes[0]]))
    host = _host(jmg.run_glimmer_mg_classes, reads, gd, cmap, user_icm=gicm)
    got = list(tmg.run_glimmer_mg_classes(reads, gd, cmap, device="cpu",
                                          user_icm=gicm))
    _assert_same(host, got)
    assert [g for _h, g in got[3:]] == [[], [], []]


def test_user_icm_mode_matches_host_engine(trained_models):
    gd, classes = trained_models
    gicm = icm_mod.read_icm_cached(gd.classes_icm_file([classes[1]]))
    reads = overlap_dense_reads(7, 30) + random_reads(8, 20, lo=100)
    host = _host(jmg.run_glimmer_mg, reads, gicm)
    tmg.reset_counters()
    got = list(tmg.run_glimmer_mg(reads, gicm, device="cpu", chunk_size=32))
    _assert_same(host, got)
    assert sum(len(g) for _h, g in got) > 10
    assert tmg.counters["device_reads"] + tmg.counters["host_reads"] == 50


def test_overflow_reads_take_the_host_route(classes_case, monkeypatch):
    """Reads past the device capacity (forced with a small MAX_EVENTS) are
    served by the host engine, counted, and give identical output."""
    gd, reads, cmap, host = classes_case
    monkeypatch.setattr(tdp, "MAX_EVENTS", 12)
    tmg.reset_counters()
    got = list(tmg.run_glimmer_mg_classes(reads, gd, cmap, device="cpu"))
    _assert_same(host, got)
    c = tmg.counters
    assert c["overflow_reads"] > 0
    assert c["host_reads"] == c["overflow_reads"]
    assert c["device_reads"] + c["host_reads"] == len(cmap)


@pytest.mark.parametrize("option", ["min_gene_len", "user_icm"])
def test_second_call_with_other_options_is_not_stale(classes_case,
                                                    trained_models, option):
    """Two calls in one process on the same reads, the second with another
    option value: each call matches the host engine under its own options
    (no bank built for the first call serves the second)."""
    gd, reads, cmap, _host_out = classes_case
    sub = reads[80:120]
    smap = {h: cmap[h] for h, _s in sub if h in cmap}
    if option == "min_gene_len":
        kw = {"min_gene_len": 150}
    else:
        classes = trained_models[1]
        kw = {"user_icm": icm_mod.read_icm_cached(
            gd.classes_icm_file([classes[1]]))}
    first = _host(jmg.run_glimmer_mg_classes, sub, gd, smap)
    second = _host(jmg.run_glimmer_mg_classes, sub, gd, smap, **kw)
    assert jmg.format_predict_mg(first) != jmg.format_predict_mg(second)
    _assert_same(first, list(tmg.run_glimmer_mg_classes(
        sub, gd, smap, device="cpu")))
    _assert_same(second, list(tmg.run_glimmer_mg_classes(
        sub, gd, smap, device="cpu", **kw)))


def test_host_engine_route_matches_jax_host_engine(classes_case):
    """host_engine=True serves every read with the exact host engine, on
    the port's classes-mode Models: the JAX package's host output."""
    gd, reads, cmap, host = classes_case
    tmg.reset_counters()
    got = list(tmg.run_glimmer_mg_classes(reads, gd, cmap, device="cpu",
                                          host_engine=True))
    _assert_same(host, got)
    assert tmg.counters["device_reads"] == 0
    assert tmg.counters["host_reads"] == len(cmap)


def test_error_modes_take_the_host_route(classes_case):
    """Substitution mode is outside this slice's device path: every read
    goes to the host engine, with the host engine's output."""
    gd, reads, cmap, _host_out = classes_case
    sub = {h: cmap[h] for h, _s in reads[:10] if h in cmap}
    host = _host(jmg.run_glimmer_mg_classes, reads[:10], gd, sub,
                 allow_subs=True)
    tmg.reset_counters()
    got = list(tmg.run_glimmer_mg_classes(reads[:10], gd, sub, device="cpu",
                                          allow_subs=True))
    _assert_same(host, got)
    assert tmg.counters["device_reads"] == 0
    assert tmg.counters["host_reads"] == len(sub)


def test_cuda_request_without_gpu_raises(classes_case):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the CPU-only machine")
    gd, reads, cmap, _host_out = classes_case
    with pytest.raises((RuntimeError, AssertionError)):
        list(tmg.run_glimmer_mg_classes(reads[:4], gd, cmap, device="cuda"))
    icm_cuda.reset_launches()
    t = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises((RuntimeError, AssertionError)):
        t.to("cuda")
    assert icm_cuda.launches == 0


def test_port_imports_and_runs_without_jax(tmp_path):
    """With ``jax`` imports blocked, the port imports and predicts a few
    reads on the CPU; it loads no JAX and no JAX-only module."""
    script = textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib"):
                    raise ImportError("jax is blocked")
                return None

        sys.meta_path.insert(0, Block())
        import numpy as np
        import glimmer_mg_torch
        from glimmer_mg_torch.engine import glimmer_mg as tmg
        from glimmer_mg_tpu.models import dna, icm_train
        from tests._torch_common import _gene_like, overlap_dense_reads

        rng = np.random.default_rng(1)
        train = [dna.encode(_gene_like(rng, 150, 0.5)) for _ in range(20)]
        gicm = icm_train.train_icm(train, model_len=12, depth=5)
        reads = overlap_dense_reads(3, 6)
        out = list(tmg.run_glimmer_mg(reads, gicm, device="cpu"))
        assert len(out) == 6 and tmg.counters["device_reads"] > 0, tmg.counters
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib")
               or m.startswith(("glimmer_mg_tpu.ops",
                                "glimmer_mg_tpu.parallel"))]
        assert not bad, bad
        print("OK", sum(len(g) for _h, g in out))
    """)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")
