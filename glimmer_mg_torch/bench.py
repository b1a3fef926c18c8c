"""The port's bench: one JSON line per metric on stdout, the LAST line the
primary end-to-end metric, diagnostics on stderr.

    python -m glimmer_mg_torch.bench [--device cuda] [--cache-dir DIR]

Counterpart of the JAX package's root ``bench.py``, with its four metrics
under the same names and units, in the same order:

  * ``icm_bank_scoring`` (Mbp*models/s): Phymm classification's bank walk,
    the bank-walk kernel on both strands (``parallel.classify.
    classify_step_kernel``, which ``classify_file`` runs), 16 perturbed
    copies of the sample-run's NC_000915.icm x 512 reads of 510 bp; each
    read of length L against M models counts L * M * 2 / 1e6 model-Mbp.
    The step is the median of 7 runs of 20 calls back to back (CUDA events
    on the card); each call's argument check syncs the host, as in
    ``classify_file``. The kernel is held bitwise to its plain twin on the
    step's own inputs. ``detail.bank256`` is the same at 256 models x 128
    reads;
  * ``gene_accuracy`` (sensitivity): ``pipeline.accuracy.
    simulated_benchmark``, the full pipeline on the device on 300 reads of
    500 bp against the projected run2.predict;
  * ``glimmer3_whole_genome`` (Mbp/s): ``engine.glimmer3.run_glimmer3``
    (run1's options) on the sample-run genome, best of 4; a host row (the
    native engine, no kernel), byte-identical to run1.predict;
  * ``glimmer_mg_reads_per_s`` (reads/s): glimmer-mg classification mode
    over the sample-run's reads with seeded class calls
    (``bench_db.bench_reads_and_classes``), tiled to 100,000 reads, on the
    native engine with its own walk; one cold pass, then the median of 5.
    ``detail.device_config`` runs the native engine on the six-frame
    kernel's scores (its ``.predict`` byte-identical to the primary's),
    ``detail.device_resident`` the device route with the f32 score carry
    (its gene coordinates identical to the primary's), on the same reads.

The sample-run it reads is the seeded synthetic stand-in that
``bench_db.build_sample_run`` writes into the cache, beside
``bench_db.build_bench_db``'s genomeData tree (8 strains, seed 7); neither
is the reference's data. ``vs_baseline`` is null in every row: the JAX
bench's baselines were the reference binaries' rates on another host, and
no reference binary is built here.

No row falls back: a row that raises, a parity flag that is false, or a
kernel that did not launch on a CUDA device ends the bench with a non-zero
exit before that row is printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from . import bench_db

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".cache", "torch_bench")

READ_LEN = 510  # multiple of 3 for the frame-phase split
STEP_CALLS, STEP_RUNS = 20, 7
BASELINE = ("null: the JAX bench's baselines (bench.py:41-48) are the "
            "reference binaries' rates on the TPU rig's host; no reference "
            "binary is built beside the card")


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The bench's sizes; the defaults are the JAX bench's."""
    strains: int = 8            # build_bench_db's strains and genes a strain
    strain_genes: int = 50
    sample_genes: int = bench_db.SAMPLE_GENES   # the stand-in's genome
    sample_reads: int = bench_db.SAMPLE_READS
    k2_models: int = 16
    k2_batch: int = 512
    bank_models: int = 256      # detail.bank256
    bank_batch: int = 128
    accuracy_reads: int = 300
    accuracy_read_len: int = 500
    reads: int = 100000         # N_BENCH_READS
    passes: int = 5
    chunks: tuple = (256, 2048)


class BenchFailure(RuntimeError):
    """A parity flag was false or a kernel did not launch."""


def _require(ok, what):
    if not ok:
        raise BenchFailure(what)


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device):
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _median(xs):
    a = sorted(xs)
    m = len(a) // 2
    return a[m] if len(a) % 2 else 0.5 * (a[m - 1] + a[m])


def _med_mad(times):
    med = _median(times)
    return med, _median([abs(x - med) for x in times])


def _timed_runs(fn, n):
    """fn() n times on the host clock (fn synchronises); (last out, s)."""
    out, times = None, []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return out, times


def prepare(cache_dir, sizes=Sizes()):
    """Build (or reuse) the bench DB and the sample-run stand-in in
    ``cache_dir``; returns (classes, db_root, sample_root, seconds)."""
    t0 = time.perf_counter()
    db_root = os.path.join(cache_dir, "bench_db")
    classes, genomes = bench_db.build_bench_db(
        db_root, n_strains=sizes.strains, n_genes=sizes.strain_genes)
    sample_root = bench_db.build_sample_run(
        os.path.join(cache_dir, "sample_run"), genomes,
        n_genes=sizes.sample_genes, n_reads=sizes.sample_reads)
    return classes, db_root, sample_root, time.perf_counter() - t0


def build_inputs(sample_root, n_models, batch, device):
    """The bank-walk row's inputs, as the JAX bench builds them:
    ``n_models`` copies of the sample-run's NC_000915.icm with probs x
    (1 + 0.01 N(0,1)) (seed 0), the same tree, so each costs what the ICM
    costs; the sample-run's reads, repeated to ``batch``, padded to 510
    bp. Returns (level_mip, probs_pk, reads, lengths, model_len, depth),
    the tensors on ``device``."""
    from .io.fasta import read_fasta
    from .models import icm as icm_mod
    from .ops import icm_cuda, icm_score
    from .parallel.classify import pad_reads

    base = icm_mod.read_icm(os.path.join(
        sample_root, "glimmer3", "results", "NC_000915.icm"))
    rng = np.random.default_rng(0)
    icms = [icm_mod.ICM(
        base.model_len, base.model_depth, base.periodicity, base.mip.copy(),
        (base.probs * (1.0 + 0.01 * rng.standard_normal(base.probs.shape)))
        .astype(np.float32)) for _ in range(n_models)]
    mip, probs = icm_score.stack_bank(icms)
    level_mip, probs_pk = icm_cuda.pack_tables(mip, probs,
                                               depth=base.model_depth)

    seqs = [s.lower() for _h, s in read_fasta(
        os.path.join(sample_root, "glimmer-mg", "seqs.fa"))]
    while len(seqs) < batch:
        seqs = seqs + seqs
    reads, lengths = pad_reads(seqs[:batch], length=READ_LEN)
    lengths = np.minimum(lengths, READ_LEN)
    return (*(torch.from_numpy(x).to(device)
              for x in (level_mip, probs_pk, reads, lengths)),
            base.model_len, base.model_depth)


def _step_ms(fn, device):
    """Milliseconds a call of fn: the median over STEP_RUNS runs of
    STEP_CALLS calls back to back, CUDA events on the card, the host
    clock on the CPU; (median, runs)."""
    fn()
    _sync(device)
    runs = []
    for _ in range(STEP_RUNS):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(STEP_CALLS):
                fn()
            b.record()
            torch.cuda.synchronize(device)
            runs.append(a.elapsed_time(b) / STEP_CALLS)
        else:
            t0 = time.perf_counter()
            for _ in range(STEP_CALLS):
                fn()
            runs.append((time.perf_counter() - t0) * 1e3 / STEP_CALLS)
    return _median(runs), runs


def _bank_case(sample_root, device, n_models, batch):
    """One bank-walk step: its model-Mbp/s and the record of its run."""
    from .ops import icm_cuda, icm_score
    from .parallel.classify import classify_step_kernel

    lm, pk, reads, lengths, model_len, depth = build_inputs(
        sample_root, n_models, batch, device)
    icm_cuda.reset_launches()

    def step():
        return classify_step_kernel(lm, pk, reads, lengths, model_len, depth)

    scores, _best = step()
    rc = icm_score.revcomp_reads(reads, lengths)
    twin = torch.maximum(*(icm_score.bank_score_reads_packed(
        lm, pk, r, lengths, model_len, depth) for r in (reads, rc)))
    same = torch.equal(scores.view(torch.int32), twin.view(torch.int32))
    err = float((scores - twin).abs().max())
    ms, runs = _step_ms(step, device)
    launches = icm_cuda.bank_walk_launches
    _require(same, f"bank walk at {n_models} models x {batch} reads differs "
                   f"from its twin (max abs err {err})")
    _require(device.type != "cuda" or launches > 0,
             "the bank-walk kernel did not launch")
    model_mbp = int(lengths.sum()) * n_models * 2 / 1e6
    return model_mbp / (ms / 1e3), {
        "models": n_models, "batch": batch, "read_len": READ_LEN,
        "step_ms": ms, "step_ms_runs": runs,
        "table_mb": (lm.nbytes + pk.nbytes) / 1e6,
        "k2_launches": launches, "max_abs_err": err,
        "bitwise_equal_twin": same}


def icm_bank_scoring(sample_root, device, sizes):
    """The ``icm_bank_scoring`` row."""
    device = torch.device(device)
    value, detail = _bank_case(sample_root, device, sizes.k2_models,
                               sizes.k2_batch)
    big_value, big = _bank_case(sample_root, device, sizes.bank_models,
                                sizes.bank_batch)
    detail["bank256"] = dict(big, value_mbp_models_per_s=big_value)
    return {"metric": "icm_bank_scoring", "value": value,
            "unit": "Mbp*models/s", "vs_baseline": None,
            "detail": dict(detail, device=_device_name(device),
                           step_calls=STEP_CALLS, baseline=BASELINE)}


def gene_accuracy(sample_root, device, work_dir, sizes):
    """The ``gene_accuracy`` row: ``simulated_benchmark`` on ``device``,
    its DB and work directory in ``work_dir``."""
    from .ops import event_dp_cuda, frontend_cuda, icm_cuda
    from .pipeline import accuracy

    device = torch.device(device)
    icm_cuda.reset_launches()
    event_dp_cuda.reset_launches()
    frontend_cuda.reset_launches()
    t0 = time.perf_counter()
    out = accuracy.simulated_benchmark(
        os.path.join(work_dir, "accuracy_wk"), n_reads=sizes.accuracy_reads,
        read_len=sizes.accuracy_read_len, sample_root=sample_root,
        device=device,
        db_root=os.path.join(work_dir, "accuracy_db"))
    _sync(device)
    seconds = time.perf_counter() - t0
    k1, k2 = icm_cuda.launches, icm_cuda.bank_walk_launches
    k3, kf = event_dp_cuda.launches, frontend_cuda.launches
    _require(device.type != "cuda" or (k1 > 0 and k2 > 0 and k3 > 0
                                       and kf > 0),
             f"gene_accuracy: a kernel did not launch (six-frame {k1}, "
             f"bank walk {k2}, event DP {k3}, frontend {kf})")
    return {"metric": "gene_accuracy", "value": out["sensitivity"],
            "unit": "sensitivity", "vs_baseline": None,
            "detail": dict(out, device=_device_name(device), k1_launches=k1,
                           k2_launches=k2, k3_launches=k3,
                           kf_launches=kf, seconds=seconds,
                           baseline=BASELINE)}


def glimmer3_whole_genome(sample_root):
    """The ``glimmer3_whole_genome`` row: run1's glimmer3 call on the
    sample-run genome, byte-identical to its run1.predict; best of 4."""
    from .engine import glimmer3 as g3
    from .io.fasta import read_fasta
    from .models import icm as icm_mod

    g3_dir = os.path.join(sample_root, "glimmer3")
    recs = list(read_fasta(os.path.join(g3_dir, "NC_000915.fna")))
    m = icm_mod.read_icm(os.path.join(g3_dir, "results", "NC_000915.icm"))

    def run():
        return g3.format_predict(list(g3.run_glimmer3(recs, m,
                                                      logodds_fudge=-12)))

    with open(os.path.join(g3_dir, "results", "NC_000915.run1.predict")) as fh:
        golden_ok = run() == fh.read()
    _require(golden_ok, "glimmer3 differs from the sample-run's run1.predict")
    _out, times = _timed_runs(run, 4)
    bp = sum(len(s) for _h, s in recs)
    return {"metric": "glimmer3_whole_genome", "value": bp / 1e6 / min(times),
            "unit": "Mbp/s", "vs_baseline": None,
            "detail": {"genome_mbp": bp / 1e6, "best_s": min(times),
                       "runs_s": times, "byte_identical_run1": golden_ok,
                       "route": "host: the native engine's whole-genome "
                                "path, no kernel",
                       "baseline": BASELINE}}


def _coords(results):
    return {h: [(g.id, g.start, g.stop, g.frame) for g in gs]
            for h, gs in results}


def glimmer_mg_reads_per_s(db_root, classes, sample_root, device, sizes):
    """The ``glimmer_mg_reads_per_s`` row (module docstring)."""
    from . import native
    from .engine import glimmer_mg as tmg
    from .io.genome_data import GenomeData
    from .ops import event_dp_cuda, frontend_cuda, icm_cuda

    device = torch.device(device)
    reads1k, lines1k = bench_db.bench_reads_and_classes(
        classes, sample_root=sample_root)
    reads, lines = bench_db.tile_reads(reads1k, lines1k, sizes.reads)
    passes = sizes.passes
    gd = GenomeData(os.path.join(db_root, "genomeData"))
    cls_map = {}
    for line in lines:
        parts = line.split()
        cls_map[parts[0]] = parts[1:]

    def run(**kw):
        out = list(tmg.run_glimmer_mg_classes(reads, gd, cls_map,
                                              device=device, **kw))
        _sync(device)
        return out

    def route(kw, same):
        """A route's checked pass then ``passes`` timed ones, counted."""
        tmg.reset_counters()
        icm_cuda.reset_launches()
        event_dp_cuda.reset_launches()
        frontend_cuda.reset_launches()
        ok = same(run(**kw))
        _out, times = _timed_runs(lambda: run(**kw), passes)
        med, mad = _med_mad(times)
        return ok, {**kw, "reads_per_s": len(reads) / med, "median_s": med,
                    "mad_s": mad, "runs_s": times, "passes": passes + 1,
                    "k1_launches": icm_cuda.launches,
                    "k3_launches": event_dp_cuda.launches,
                    "kf_launches": frontend_cuda.launches,
                    "counters": dict(tmg.counters)}

    primary = {"engine": "native", "precompute": "host"}
    t0 = time.perf_counter()
    run(**primary)
    cold_s = time.perf_counter() - t0
    tmg.reset_counters()
    results, times = _timed_runs(lambda: run(**primary), passes)
    counters = dict(tmg.counters)
    text = tmg.format_predict_mg(results)
    by_chunk = {}
    for chunk in sizes.chunks:
        _out, t = _timed_runs(lambda: run(chunk_size=chunk, **primary), 1)
        by_chunk[str(chunk)] = len(reads) / t[0]

    ok_c, dev_cfg = route({"engine": "native", "precompute": "device"},
                          lambda out: tmg.format_predict_mg(out) == text)
    dev_cfg["byte_identical"] = ok_c
    coords = _coords(results)
    ok_r, dev_res = route({"engine": "device", "f64": False},
                          lambda out: _coords(out) == coords)
    dev_res["coords_identical"] = ok_r
    _require(ok_c, "device_config's .predict differs from the primary's")
    _require(ok_r, "device_resident's gene coordinates differ from the "
                   "primary's")
    _require(device.type != "cuda" or (dev_cfg["k1_launches"] > 0
                                       and dev_res["k1_launches"] > 0),
             "the six-frame kernel did not launch")
    _require(device.type != "cuda" or dev_res["k3_launches"] > 0,
             "the event-DP kernel did not launch on the device route")
    _require(device.type != "cuda" or dev_res["kf_launches"] > 0,
             "the frontend kernel did not launch on the device route")
    med, mad = _med_mad(times)
    return {"metric": "glimmer_mg_reads_per_s", "value": len(reads) / med,
            "unit": "reads/s", "vs_baseline": None,
            "detail": {"device": _device_name(device), "reads": len(reads),
                       "genes": sum(len(g) for _h, g in results), **primary,
                       "threads": native.default_threads(),
                       "median_s": med, "mad_s": mad, "best_s": min(times),
                       "reads_per_s_best": len(reads) / min(times),
                       "runs_s": times, "cold_s": cold_s,
                       "counters": counters,
                       "reads_per_s_by_chunk": by_chunk,
                       "device_config": dev_cfg,
                       "device_resident": dev_res, "baseline": BASELINE}}


def main(argv=None, sizes=Sizes()):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache-dir", default=CACHE_DIR)
    args = ap.parse_args(argv)
    from .engine.glimmer_mg import _check_device

    device = _check_device(args.device)
    classes, db_root, sample_root, build_s = prepare(args.cache_dir, sizes)
    _log(f"bench DB and sample-run stand-in in {args.cache_dir}: "
         f"{build_s:.1f} s")
    rows = (lambda: icm_bank_scoring(sample_root, device, sizes),
            lambda: gene_accuracy(sample_root, device, args.cache_dir, sizes),
            lambda: glimmer3_whole_genome(sample_root),
            lambda: glimmer_mg_reads_per_s(db_root, classes, sample_root,
                                           device, sizes))
    try:
        for row in rows:  # the JAX bench's order, each printed when done
            print(json.dumps(row()), flush=True)
    except BenchFailure as e:
        _log(f"bench failed: {e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
