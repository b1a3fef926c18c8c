#!/usr/bin/env python3
"""Drive the PyTorch port's per-read gene prediction on one NVIDIA GPU.

    python3 chip_smoke.py [--reads 8192] [--genome-kb 200] [--check 256]

Phases (any failure raises and exits non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     and the build of the kernels in glimmer_mg_torch/csrc into build/;
  2. K1, the six-frame ICM walk kernel, against its plain PyTorch twin on
     the card at the main path's shapes (B 2,048 x L 768, 16 model groups
     of depth-7 ICMs): bitwise equal; median times of both (CUDA events);
  3. the main path: a model database trained with train_all on 4 synthetic
     genomes (GC 0.35/0.45/0.55/0.65), reads of 300/500/700 bp sampled
     from them, each classified to its source genome and every other read
     also to a second genome, predicted by the port's
     run_glimmer_mg_classes(device="cuda"). Checks: K1 launched, only
     overflow reads took the host route (at most 5%), the first reads'
     .predict text byte-identical to the exact host engine (the JAX
     package's pure numpy/Python per-read engine, which the port imports
     and runs with host_engine=True), finite scores. Prints warm reads/s
     from a second pass, a third pass's wall time split by layer, a pass
     with the f32 score carry, and a per-stage breakdown of one chunk.

The script imports only glimmer_mg_torch (and, through it, the JAX-free
host layers of glimmer_mg_tpu); no JAX module is loaded.

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Without CUDA it raises before printing a
result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

DEVICE = "cuda"


def log(msg):
    print(msg, flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def synth_genome(rng, gc, size):
    """Gene-dense synthetic genome: GC-weighted sense codons between
    ATG and a stop, on both strands, separated by GC-weighted spacers."""
    import numpy as np

    base_p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    codons = [a + b + c for a in "ACGT" for b in "ACGT" for c in "ACGT"]
    sense = [c for c in codons if c not in ("TAA", "TAG", "TGA")]
    w = np.array([np.prod([base_p["ACGT".index(ch)] for ch in c])
                  for c in sense])
    w /= w.sum()
    comp = str.maketrans("ACGT", "TGCA")
    parts, total = [], 0
    while total < size:
        spacer = "".join(rng.choice(list("ACGT"), int(rng.integers(30, 250)),
                                    p=base_p))
        body = "".join(np.asarray(sense)[rng.choice(
            len(sense), int(rng.integers(100, 500)), p=w)])
        gene = "ATG" + body + str(rng.choice(["TAA", "TAG", "TGA"]))
        if rng.random() < 0.5:
            gene = gene[::-1].translate(comp)
        parts += [spacer, gene]
        total += len(spacer) + len(gene)
    return "".join(parts)[:size]


def build_database(root, genome_kb, seed):
    import numpy as np

    from glimmer_mg_torch.host import GenomeData, train_all

    rng = np.random.default_rng(seed)
    genomes = {f"g{k}|chr": synth_genome(rng, gc, genome_kb * 1000)
               for k, gc in enumerate((0.35, 0.45, 0.55, 0.65))}
    train_all(genomes, os.path.join(root, "genomeData"))
    return GenomeData(os.path.join(root, "genomeData")), genomes


def sample_reads(genomes, n_reads, seed):
    """Reads of 300/500/700 bp from random genome positions (half
    reverse-complemented); each classified to its source genome, every
    other read also to a second genome."""
    import numpy as np

    rng = np.random.default_rng(seed)
    names = list(genomes)
    comp = str.maketrans("acgt", "tgca")
    reads, cmap = [], {}
    for i in range(n_reads):
        src = int(rng.integers(len(names)))
        g = genomes[names[src]].lower()
        ln = (300, 500, 700)[i % 3]
        st = int(rng.integers(0, len(g) - ln))
        s = g[st:st + ln]
        if rng.random() < 0.5:
            s = s[::-1].translate(comp)
        h = f"read{i}"
        reads.append((h, s))
        cls = [names[src]]
        if i % 2 == 1:
            cls.append(names[(src + 1 + int(rng.integers(3))) % 4])
        cmap[h] = cls
    return reads, cmap


def cuda_ms(fn, reps=5):
    """Median milliseconds of fn() over reps runs, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def sixframe_phase(gd, genomes, seed):
    """K1 vs its twin at the main path's shapes; returns its record."""
    import numpy as np
    import torch

    from glimmer_mg_torch.engine import glimmer_mg as tmg
    from glimmer_mg_torch.host import dna
    from glimmer_mg_torch.ops import device_predict as dpk
    from glimmer_mg_torch.ops import icm_cuda, icm_score

    names = list(genomes)
    combos = [[a] for a in names] + [[a, b] for a in names for b in names
                                     if a != b]
    models = [tmg.classes_models(
        c, 700, gd, parsed=None, user_icm=None, user_gc=None,
        user_rbs_pwm=None, user_stop_codons=None, fudge_f32=np.float32(1.0),
        min_gene_len=75, max_olap_bases=50, circular=False, icm_cache={})
        for c in combos]
    assert len(models) == 16
    bank = dpk.build_bank(models, 768)
    assert bank.depth == 7, bank.depth
    dev = dpk.bank_to_device(bank, DEVICE)
    reads_np, _ = sample_reads(genomes, 2048, seed + 1)
    B, L = 2048, 768
    rng = np.random.default_rng(seed + 2)
    reads = np.zeros((B, L), np.int32)
    lens = np.zeros(B, np.int32)
    for r, (_h, s) in enumerate(reads_np):
        reads[r, :len(s)] = dna.encode(s)
        lens[r] = len(s)
    grp = rng.integers(0, 16, B).astype(np.int32)
    t = [torch.from_numpy(a).to(DEVICE) for a in (reads, lens, grp)]
    args = (dev["gene_mip"], dev["gene_probs"], dev["indep_mip"],
            dev["indep_probs"], *t)
    kw = dict(model_len=bank.model_len, depth=bank.depth)

    icm_cuda.reset_launches()
    kg, ki = icm_cuda.mg_six_frame(*args, **kw)
    torch.cuda.synchronize()
    assert icm_cuda.launches == 1
    tg, ti = icm_score.mg_six_frame_batch(*args, **kw)
    torch.cuda.synchronize()
    bitwise = (torch.equal(kg.view(torch.int32), tg.view(torch.int32))
               and torch.equal(ki.view(torch.int32), ti.view(torch.int32)))
    err = max(float((kg - tg).abs().max()), float((ki - ti).abs().max()))
    if not bitwise:
        raise AssertionError(f"six_frame kernel differs from twin ({err})")
    ms = cuda_ms(lambda: icm_cuda.mg_six_frame(*args, **kw))
    plain_ms = cuda_ms(lambda: icm_score.mg_six_frame_batch(*args, **kw))
    log(f"K1 six_frame vs twin at B={B} L={L} G=16 depth={bank.depth}: "
        f"bitwise equal; kernel {ms:.4f} ms, twin {plain_ms:.4f} ms "
        f"(median of 5, CUDA events)")
    return {"name": "six_frame", "route": "cuda",
            "source": "glimmer_mg_torch/csrc/six_frame.cu",
            "replaces": "glimmer_mg_tpu/ops/icm_pallas.py:402",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def timed_pass(gd, reads, cmap, want):
    """One more warm pass with its host-clock time split by layer. Each
    engine stage is wrapped with a timer; the device stages end in a
    synchronise, so the device time is theirs and the parts add up to the
    pass's wall time ("other": encoding, emission order, padding)."""
    import torch

    from glimmer_mg_torch.engine import glimmer_mg as tmg
    from glimmer_mg_torch.ops import device_predict as dpk
    from glimmer_mg_torch.ops import icm_cuda

    parts = {}

    def timed(fn, key, sync):
        def run(*a, **kw):
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            parts[key] = parts.get(key, 0.0) + time.perf_counter() - t0
            return res
        return run

    stages = [(tmg, "classes_models", "models", False),
              (tmg, "_bank_for", "bank", False),
              (icm_cuda, "mg_six_frame", "six_frame", True),
              (dpk, "predict_batch_device", "frontend_dp_traceback", True),
              (dpk, "finish_genes", "finish_genes", False),
              (tmg, "_host_predict", "host_engine", False)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _k, _s in stages]
    try:
        for mod, name, key, sync in stages:
            setattr(mod, name, timed(getattr(mod, name), key, sync))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = list(tmg.run_glimmer_mg_classes(reads, gd, cmap,
                                              device=DEVICE))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    assert tmg.format_predict_mg(got) == tmg.format_predict_mg(want)
    parts["other"] = wall - sum(parts.values())
    log(f"timed warm pass: {len(reads)} reads in {wall:.4f} s; parts (s, "
        "host clock, device stages synchronised): "
        + json.dumps({k: round(v, 4) for k, v in parts.items()})
        + "; shares: " + json.dumps({k: round(v / wall, 3)
                                     for k, v in parts.items()}))


def f32_pass(gd, reads, cmap, want):
    """A warm pass with the f32 score carry: reads/s and how many reads'
    .predict text differs from the f64 run."""
    import torch

    from glimmer_mg_torch.engine import glimmer_mg as tmg

    list(tmg.run_glimmer_mg_classes(reads[:256], gd, cmap, device=DEVICE,
                                    f64=False))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = list(tmg.run_glimmer_mg_classes(reads, gd, cmap, device=DEVICE,
                                          f64=False))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    differ = sum(tmg.format_predict_mg([a]) != tmg.format_predict_mg([b])
                 for a, b in zip(want, got))
    log(f"f32 carry warm pass: {len(reads)} reads in {wall:.4f} s = "
        f"{len(reads) / wall:.1f} reads/s; reads whose text differs from "
        f"the f64 run: {differ}")


def stage_breakdown(gd, reads, cmap):
    """Host-clock stage times (synchronised) of one 2,048-read chunk."""
    import torch

    from glimmer_mg_torch.engine import glimmer_mg as tmg
    from glimmer_mg_torch.host import dna
    from glimmer_mg_torch.ops import device_predict as dpk
    from glimmer_mg_torch.ops import event_dp, frontend, icm_cuda

    chunk = reads[:2048]
    cache, ids, models, group = {}, {}, [], []
    for h, s in chunk:
        key = (tuple(cmap[h]), len(s))
        if key not in cache:
            cache[key] = tmg.classes_models(
                list(key[0]), len(s), gd, parsed=None, user_icm=None,
                user_gc=None, user_rbs_pwm=None, user_stop_codons=None,
                fudge_f32=1.0, min_gene_len=75, max_olap_bases=50,
                circular=False, icm_cache={})
        m = cache[key]
        ids.setdefault(id(m), len(models))
        if len(models) == ids[id(m)]:
            models.append(m)
        group.append(ids[id(m)])
    bank = dpk.build_bank(models, 768)
    dev = dpk.bank_to_device(bank, DEVICE)
    reads_t = torch.zeros((len(chunk), 768), dtype=torch.int32)
    for r, (_h, s) in enumerate(chunk):
        reads_t[r, :len(s)] = torch.from_numpy(dna.encode(s).astype("int32"))
    reads_t = reads_t.to(DEVICE)
    lens = torch.tensor([len(s) for _h, s in chunk],
                        dtype=torch.int32).to(DEVICE)
    grp = torch.tensor(group, dtype=torch.int32).to(DEVICE)
    consts = dict(min_gene_len=bank.min_gene_len, max_olap=bank.max_olap,
                  event_threshold=bank.event_threshold,
                  start_threshold=bank.start_threshold,
                  ws=bank.ribosome_window, W=bank.pwm_w, fdt=torch.float64)
    times = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    g6, i6 = stage("six_frame", lambda: icm_cuda.mg_six_frame(
        dev["gene_mip"], dev["gene_probs"], dev["indep_mip"],
        dev["indep_probs"], reads_t, lens, grp, model_len=bank.model_len,
        depth=bank.depth))
    ev, n_ev = stage("frontend", lambda: frontend.frontend(
        reads_t, lens, grp, g6, i6, dev, 768, consts, dpk.MAX_EVENTS))
    ne = torch.clamp(n_ev, max=dpk.MAX_EVENTS)
    adj = event_dp._prefetch_adj(dev, grp)
    sc, bp, best, _w = stage("event_dp", lambda: event_dp.event_dp_batched(
        ev, adj, consts, ne))
    syncs = event_dp.last_syncs
    stage("traceback", lambda: event_dp.traceback_batched(ev, sc, bp, best,
                                                          ne))
    log(f"stage breakdown, one {len(chunk)}-read chunk "
        "(ms, host clock, synchronised): "
        + json.dumps({k: round(v, 3) for k, v in times.items()})
        + f"; DP steps {int(ne.max())}, host syncs {syncs}")


def profile_pass(gd, reads, cmap):
    """One more warm pass under torch.profiler: device busy share (sum of
    kernel times over the pass's wall time) and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from glimmer_mg_torch.engine import glimmer_mg as tmg

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        list(tmg.run_glimmer_mg_classes(reads, gd, cmap, device=DEVICE))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time for e in kern)
    by_name = {}
    for e in kern:
        key = e.name[:60]
        by_name[key] = by_name.get(key, 0.0) + e.device_time
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"profile: wall {wall_us / 1e3:.1f} ms, kernels {len(kern)}, "
        f"device busy {busy_us / 1e3:.1f} ms = {busy_us / wall_us:.3f} of "
        f"wall; top (ms): " + json.dumps({k: round(v / 1e3, 2)
                                          for k, v in top}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=8192)
    ap.add_argument("--genome-kb", type=int, default=200)
    ap.add_argument("--check", type=int, default=256)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--profile", action="store_true",
                    help="profile one more warm pass (device busy share)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA GPU; none is available")

    from glimmer_mg_torch import _build
    from glimmer_mg_torch.engine import glimmer_mg as tmg
    from glimmer_mg_torch.ops import icm_cuda

    log(gpu_line())
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build()
    _build.lib()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds})")

    with tempfile.TemporaryDirectory(prefix="gmt_smoke_") as root:
        t0 = time.perf_counter()
        gd, genomes = build_database(root, args.genome_kb, args.seed)
        log(f"database: train_all on 4 x {args.genome_kb} kb in "
            f"{time.perf_counter() - t0:.1f} s")

        record = sixframe_phase(gd, genomes, args.seed)

        reads, cmap = sample_reads(genomes, args.reads, args.seed + 3)
        # pass 1 (cold: model construction, bank build) with the counts
        tmg.reset_counters()
        icm_cuda.reset_launches()
        t0 = time.perf_counter()
        out = list(tmg.run_glimmer_mg_classes(reads, gd, cmap,
                                              device=DEVICE))
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = icm_cuda.launches
        counts = dict(tmg.counters)
        log(f"main path pass 1: {len(out)} reads in {cold:.2f} s; "
            f"K1 launches {launches}; routes {counts}")
        assert launches > 0, "the main path did not launch K1"
        assert len(out) == len(reads)
        assert counts["device_reads"] + counts["host_reads"] == len(reads)
        assert counts["host_reads"] == counts["overflow_reads"], counts
        assert counts["host_reads"] <= 0.05 * len(reads), counts
        n_genes = sum(len(g) for _h, g in out)
        assert n_genes > len(reads) // 4, n_genes
        for _h, genes in out:
            for g in genes:
                assert g.score == g.score and abs(g.score) < 1e6
                assert g.frame in (-3, -2, -1, 1, 2, 3)

        # pass 2 (warm): reads/s
        t0 = time.perf_counter()
        out2 = list(tmg.run_glimmer_mg_classes(reads, gd, cmap,
                                               device=DEVICE))
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        assert tmg.format_predict_mg(out2) == tmg.format_predict_mg(out)
        log(f"main path pass 2 (warm): {len(reads)} reads in {warm:.3f} s = "
            f"{len(reads) / warm:.1f} reads/s; {n_genes} genes")

        # the first reads against the exact host engine (the JAX package's
        # pure-Python per-read engine, reached through the port's router)
        sub = reads[:args.check]
        sub_map = {h: cmap[h] for h, _s in sub}
        host = list(tmg.run_glimmer_mg_classes(sub, gd, sub_map,
                                               device=DEVICE,
                                               host_engine=True))
        by_header = dict(out)
        mine = [(h, by_header[h]) for h, _g in host]
        same = tmg.format_predict_mg(host) == tmg.format_predict_mg(mine)
        log(f"first {len(sub)} reads vs host engine: "
            f"{'byte-identical' if same else 'DIFFER'} "
            f"({sum(len(g) for _h, g in host)} genes)")
        assert same, "port output differs from the host engine"

        timed_pass(gd, reads, cmap, out)
        f32_pass(gd, reads, cmap, out)
        stage_breakdown(gd, reads, cmap)
        if args.profile:
            profile_pass(gd, reads, cmap)

    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
           or m.startswith(("glimmer_mg_tpu.ops", "glimmer_mg_tpu.parallel"))]
    assert not bad, f"JAX modules were loaded: {bad[:5]}"
    record["launches"] = launches
    record = {k: record[k] for k in ("name", "route", "source", "replaces",
                                     "launches", "max_abs_err", "ms",
                                     "plain_ms")}
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
