#!/usr/bin/env python3
"""Drive the PyTorch port's prediction and classification paths on one NVIDIA GPU.

    python3 chip_smoke.py [--reads 8192] [--genome-kb 200] [--check 256]
                          [--decoys 508]

Phases (any failure raises and exits non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     and the build of the kernels in glimmer_mg_torch/csrc into build/;
  2. the model database: train_all on 4 synthetic genomes (GC
     0.35/0.45/0.55/0.65) plus 508 decoy genome ICMs (seeded perturbed
     copies of the 4 trained ones, the same trees), 512 ICMs of depth 7;
  3. K1, the six-frame ICM walk kernel, against its plain PyTorch twin on
     the card at the prediction path's shapes (B 2,048 x L 768, 16 model
     groups of depth-7 ICMs): bitwise equal; median times of both (CUDA
     events);
  4. K2, the Phymm bank-walk kernel, against its twin at one
     classification batch of the full bank (B 512 x L 702 x M 512):
     bitwise equal; median times of both, the kernel's model-Mbp/s;
  5. the prediction path: reads of 300/500/700 bp sampled from the
     genomes, each classified to its source genome and every other read
     also to a second genome, predicted by the port's
     run_glimmer_mg_classes(device="cuda"). Checks: K1 launched, only
     overflow reads took the host route (at most 5%), the first reads'
     .predict text byte-identical to the exact host engine (the JAX
     package's pure numpy/Python per-read engine, which the port imports
     and runs with host_engine=True), finite scores. Prints warm reads/s
     from a second pass, a third pass's wall time split by layer, a pass
     with the f32 score carry, and a per-stage breakdown of one chunk;
  6. the pipeline path: the same reads as a FASTA file through the port's
     run_pipeline(device="cuda", iterate=0): classification against the
     512-ICM bank (K2), class parsing, prediction (K1). Checks: both
     kernels launched, 512 ICM rows in the raw matrix, the first class is
     the source genome for at least 90% of the reads, the first reads'
     scores within length/512 of the exact walk on the card and their
     .predict text byte-identical to the host engine on the same
     .class.txt, the prediction routing limits of phase 5. Prints a warm
     classify_file call's reads/s, model-Mbp/s and wall split by layer,
     and a warm pipeline run's wall split by stage.

The script imports only glimmer_mg_torch (and, through it, the JAX-free
host layers of glimmer_mg_tpu); no JAX module is loaded.

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Without CUDA it raises before printing a
result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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


def add_decoys(icm_dir, n, seed):
    """``n`` decoy genome ICMs: seeded perturbed copies of the trained ones
    (log-probs x (1 + 0.01 N(0,1)), the same tree, so each costs what a
    real ICM costs to score), written to <icm_dir>/decoy{k:03d}/d{k:03d}.icm.
    They have no .gicm or adjacency files, so informative_genomes leaves
    them out of the classes."""
    import numpy as np

    from glimmer_mg_torch.host import read_icm, write_icm
    from glimmer_mg_torch.parallel.phymm import genome_icm_paths

    rng = np.random.default_rng(seed)
    base = [read_icm(p) for p in genome_icm_paths(icm_dir)]
    for k in range(n):
        src = base[k % len(base)]
        noise = 1.0 + 0.01 * rng.standard_normal(src.probs.shape)
        decoy = dataclasses.replace(src, mip=src.mip.copy(),
                                    probs=(src.probs * noise).astype("float32"))
        out = os.path.join(icm_dir, f"decoy{k:03d}")
        os.makedirs(out)
        write_icm(decoy, os.path.join(out, f"d{k:03d}.icm"))


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


def bankwalk_phase(bank, genomes, seed):
    """K2 vs its twin at one classification batch of the full bank (B 512
    x L 702 x all ICMs); returns its record."""
    import torch

    from glimmer_mg_torch.ops import icm_cuda, icm_score
    from glimmer_mg_torch.parallel.classify import pad_reads

    sample, _ = sample_reads(genomes, 512, seed + 4)
    reads, lengths = pad_reads([s for _h, s in sample], length=702)
    args = (*bank.tables, torch.from_numpy(reads).to(DEVICE),
            torch.from_numpy(lengths).to(DEVICE), bank.model_len, bank.depth)
    m = bank.tables[0].shape[0]

    icm_cuda.reset_launches()
    got = icm_cuda.bank_score_reads_kernel(*args)
    torch.cuda.synchronize()
    assert icm_cuda.bank_walk_launches == 1
    want = icm_score.bank_score_reads_packed(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"bank_walk kernel differs from twin ({err})")
    assert bool(torch.isfinite(got).all()) and bool((got <= 0).all())
    ms = cuda_ms(lambda: icm_cuda.bank_score_reads_kernel(*args))
    plain_ms = cuda_ms(lambda: icm_score.bank_score_reads_packed(*args),
                       reps=3)
    model_mbp = float(lengths.sum()) * m / 1e6
    log(f"K2 bank_walk vs twin at B=512 L=702 M={m} depth={bank.depth}: "
        f"bitwise equal; kernel {ms:.4f} ms (median of 5), twin "
        f"{plain_ms:.4f} ms (median of 3), CUDA events; kernel "
        f"{model_mbp / (ms / 1e3):.1f} model-Mbp/s "
        f"({model_mbp:.1f} model-Mbp per launch)")
    return {"name": "bank_walk", "route": "cuda",
            "source": "glimmer_mg_torch/csrc/bank_walk.cu",
            "replaces": "glimmer_mg_tpu/ops/icm_pallas.py:201",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


@contextlib.contextmanager
def wrapped_parts(stages):
    """For the block, wrap each (module or class, attribute, key, sync) in
    a host timer; yields the dict of seconds per key. Device stages end in
    a synchronise, so the device time is theirs."""
    import torch

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

    saved = [(obj, name, getattr(obj, name)) for obj, name, _k, _s in stages]
    try:
        for obj, name, key, sync in stages:
            setattr(obj, name, timed(getattr(obj, name), key, sync))
        yield parts
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def log_parts(title, wall, parts):
    """Log a wall time split into parts plus "other" (the rest)."""
    parts["other"] = wall - sum(parts.values())
    log(f"{title} in {wall:.4f} s; parts (s, host clock, device stages "
        "synchronised): " + json.dumps({k: round(v, 4)
                                        for k, v in parts.items()})
        + "; shares: " + json.dumps({k: round(v / wall, 3)
                                     for k, v in parts.items()}))


def timed_pass(gd, reads, cmap, want):
    """One more warm pass with its host-clock time split by layer; the
    parts add up to the pass's wall time ("other": encoding, emission
    order, padding)."""
    import torch

    from glimmer_mg_torch.engine import glimmer_mg as tmg
    from glimmer_mg_torch.ops import device_predict as dpk
    from glimmer_mg_torch.ops import icm_cuda

    stages = [(tmg, "classes_models", "models", False),
              (tmg, "_bank_for", "bank", False),
              (icm_cuda, "mg_six_frame", "six_frame", True),
              (dpk, "predict_batch_device", "frontend_dp_traceback", True),
              (dpk, "finish_genes", "finish_genes", False),
              (tmg, "_host_predict", "host_engine", False)]
    with wrapped_parts(stages) as parts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = list(tmg.run_glimmer_mg_classes(reads, gd, cmap,
                                              device=DEVICE))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    assert tmg.format_predict_mg(got) == tmg.format_predict_mg(want)
    log_parts(f"timed warm pass: {len(reads)} reads", wall, parts)


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


def predict_blocks(text):
    """header -> its .predict block (header line and gene rows)."""
    blocks, cur = {}, None
    for line in text.splitlines(keepends=True):
        if line.startswith(">"):
            cur = line[1:].rstrip("\n")
            blocks[cur] = ""
        blocks[cur] += line
    return blocks


def pipeline_phase(root, icm_dir, gd, bank, reads, cmap, check):
    """The slice's path: a FASTA file through run_pipeline(iterate=0) on
    the card (classify with K2, parse classes, predict with K1), counted
    and checked. Returns (K1 launches, K2 launches, the FASTA path)."""
    import numpy as np
    import torch

    from glimmer_mg_torch.engine import glimmer_mg as tmg
    from glimmer_mg_torch.host import write_fasta
    from glimmer_mg_torch.ops import icm_cuda
    from glimmer_mg_torch.parallel import phymm
    from glimmer_mg_torch.pipeline import glimmer_mg_pipe as pipe

    fa = os.path.join(root, "reads.fa")
    write_fasta(fa, reads)
    work = os.path.join(root, "pipe")
    tmg.reset_counters()
    icm_cuda.reset_launches()
    t0 = time.perf_counter()
    final = pipe.run_pipeline(fa, icm_dir, device=DEVICE, iterate=0,
                              workdir=work)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    k1, k2 = icm_cuda.launches, icm_cuda.bank_walk_launches
    counts = dict(tmg.counters)
    log(f"pipeline path (cold): {len(reads)} reads in {cold:.2f} s; "
        f"K2 launches {k2}, K1 launches {k1}; routes {counts}")
    assert k2 > 0, "the pipeline did not launch K2"
    assert k1 > 0, "the pipeline did not launch K1"

    paths, rids, raw = phymm.read_raw_phymm_output(
        os.path.join(work, phymm.raw_phymm_name(fa)))
    assert paths == bank.paths, len(paths)
    assert rids == [h for h, _s in reads]
    assert raw.shape == (len(reads), len(paths))
    classes = {}
    with open(os.path.join(work, "reads.class.txt")) as fh:
        for line in fh:
            rid, cls = line.rstrip("\n").split("\t")
            classes[rid] = cls.split()
    sources = {c[0] for c in cmap.values()}
    informative = pipe.informative_genomes(icm_dir)
    assert informative == sources, (informative, sources)
    # accuracy as the JAX package's test takes it: the best-scoring genome
    # (decoys left out, as the classes leave them out). The class file's
    # first class is not always the best one: the reference's streaming
    # insert (running_top_k) fills the first k slots unsorted.
    cols = [g for g, p in enumerate(paths)
            if phymm.path_to_genome(p) in informative]
    best = [phymm.path_to_genome(paths[cols[c]])
            for c in raw[:, cols].argmax(axis=1)]
    acc = float(np.mean([b == cmap[h][0] for b, (h, _s) in zip(best, reads)]))
    first = float(np.mean([classes[h][0] == cmap[h][0] for h, _s in reads]))
    among = float(np.mean([cmap[h][0] in classes[h] for h, _s in reads]))
    log(f"best-scoring genome = source genome for {acc:.4f} of reads "
        f"({len(informative)} informative genomes); the source is the "
        f"first class for {first:.4f} and among the classes for {among:.4f}")
    assert acc >= 0.9, acc
    assert counts["device_reads"] + counts["host_reads"] == len(reads)
    assert counts["host_reads"] == counts["overflow_reads"], counts
    assert counts["host_reads"] <= 0.05 * len(reads), counts

    sub = reads[:check]
    seqs = [s for _h, s in sub]
    fixed = bank.score_reads(seqs)
    exact = bank.score_reads(seqs, use_kernel=False)
    lens = np.array([len(s) for s in seqs], np.float64)[:, None]
    drift = np.abs(exact.astype(np.float64) - fixed) / lens
    agree = np.mean(exact.argmax(1) == fixed.argmax(1))
    agree_inf = np.mean(exact[:, cols].argmax(1) == fixed[:, cols].argmax(1))
    log(f"first {len(sub)} reads, exact walk vs K2 route on the card: "
        f"max |diff|/bp {drift.max():.3e} (bound 1/512 = {1 / 512:.3e}); "
        f"argmax agrees for {agree:.4f} over all ICMs (decoys are 1% "
        f"perturbations), {agree_inf:.4f} over the informative genomes")
    assert (drift <= 1 / 512).all()
    printed = np.array([[float("%.4f" % x) for x in row] for row in fixed])
    assert np.array_equal(raw[:len(sub)], printed), "raw matrix != K2 route"

    host = list(tmg.run_glimmer_mg_classes(
        sub, gd, {h: classes[h] for h, _s in sub}, device=DEVICE,
        host_engine=True))
    with open(final) as fh:
        blocks = predict_blocks(fh.read())
    same = "".join(blocks[h] for h, _g in host) == tmg.format_predict_mg(host)
    log(f"first {len(sub)} reads of the pipeline's .predict vs host engine "
        f"on the same .class.txt: {'byte-identical' if same else 'DIFFER'} "
        f"({sum(len(g) for _h, g in host)} genes)")
    assert same, "pipeline output differs from the host engine"
    return k1, k2, fa


def classify_warm(fa, icm_dir, root, n_reads, bp):
    """A warm classify_file call: reads/s, model-Mbp/s (both strands) and
    its wall split by layer."""
    import torch

    from glimmer_mg_torch.ops import icm_cuda
    from glimmer_mg_torch.parallel import phymm

    out = os.path.join(root, "classify_warm")
    os.makedirs(out)
    stages = [(phymm.PhymmBank, "__init__", "bank_read_pack_upload", True),
              (icm_cuda, "bank_score_reads_kernel", "bank_walk", True),
              (phymm, "write_raw_phymm_output", "raw_file", False),
              (phymm, "write_results_table", "results_file", False)]
    with wrapped_parts(stages) as parts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths, _rids, _s = phymm.classify_file(fa, icm_dir, out_dir=out,
                                               device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(f"warm classify_file: {n_reads} reads x {len(paths)} ICMs, "
        f"{n_reads / wall:.1f} reads/s, "
        f"{2 * bp * len(paths) / 1e6 / wall:.1f} model-Mbp/s (fwd + rc)")
    log_parts("warm classify_file", wall, parts)


def pipeline_warm(fa, icm_dir, root):
    """A warm run_pipeline(iterate=0) with its wall split by stage."""
    import torch

    from glimmer_mg_torch.pipeline import glimmer_mg_pipe as pipe

    timers = pipe.StageTimers()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run_pipeline(fa, icm_dir, device=DEVICE, iterate=0,
                      workdir=os.path.join(root, "pipe_warm"), timers=timers)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log_parts("warm pipeline (iterate=0)", wall,
              {st.name: st.wall_s for st in timers.stages})


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
    ap.add_argument("--decoys", type=int, default=508,
                    help="decoy genome ICMs added to the 4 trained ones")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more warm pass (device busy share)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA GPU; none is available")

    from glimmer_mg_torch import _build
    from glimmer_mg_torch.engine import glimmer_mg as tmg
    from glimmer_mg_torch.ops import icm_cuda
    from glimmer_mg_torch.parallel import phymm

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
        icm_dir = os.path.join(root, "genomeData")
        add_decoys(icm_dir, args.decoys, args.seed + 5)
        log(f"database: train_all on 4 x {args.genome_kb} kb + "
            f"{args.decoys} decoy ICMs in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        bank = phymm.PhymmBank.from_genome_data(icm_dir, DEVICE)
        assert len(bank.paths) == 4 + args.decoys, len(bank.paths)
        log(f"Phymm bank: {len(bank.paths)} ICMs of depth {bank.depth}, "
            f"packed tables {sum(t.nbytes for t in bank.tables) / 1e6:.1f} "
            f"MB on the card, read + packed + uploaded in "
            f"{time.perf_counter() - t0:.1f} s")

        record = sixframe_phase(gd, genomes, args.seed)
        k2_record = bankwalk_phase(bank, genomes, args.seed)

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
        log(f"prediction path pass 1: {len(out)} reads in {cold:.2f} s; "
            f"K1 launches {launches}; routes {counts}")
        assert launches > 0, "the prediction path did not launch K1"
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
        log(f"prediction path pass 2 (warm): {len(reads)} reads in "
            f"{warm:.3f} s = "
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

        _k1, k2_launches, fa = pipeline_phase(root, icm_dir, gd, bank, reads,
                                              cmap, args.check)
        del bank
        classify_warm(fa, icm_dir, root, len(reads),
                      sum(len(s) for _h, s in reads))
        pipeline_warm(fa, icm_dir, root)

    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
           or m.startswith(("glimmer_mg_tpu.ops", "glimmer_mg_tpu.parallel"))]
    assert not bad, f"JAX modules were loaded: {bad[:5]}"
    record["launches"] = launches
    k2_record["launches"] = k2_launches
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in (record, k2_record)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
