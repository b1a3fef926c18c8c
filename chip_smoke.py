#!/usr/bin/env python3
"""Drive the PyTorch port's paths, clustering included, on one NVIDIA GPU.

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
     groups of depth-7 ICMs): bitwise equal; median times (CUDA events)
     of the wrapper call as the engine makes it (index ranges checked on
     the host, no host sync) and with its device range check, of the
     kernel alone (device time) warm and L2-cold, and of the twin;
     ptxas's registers and the block's shared memory;
  4. K2, the Phymm bank-walk kernel, against its twin at one
     classification batch of the full bank (B 512 x L 702 x M 512), one
     strand and both strands in one launch: bitwise equal; median times of
     the kernel and the twin, the kernel's model-Mbp/s, its bound;
  4b. K2 over 8-bit tables (pack_tables_int8, 16 models at a time) against
     the 8-bit twin at the same shape, one strand: bitwise equal; times and
     bound. No path of the port runs it (as in the JAX package);
  4c. the raw-text kernel (the raw matrix's %.4f rows) at 16,384 reads x
     539 ICMs: byte-identical to its plain version; the device time of its
     four kernels warm and L2-cold beside its bound, the plain version's
     host time, and the writer's text part (upload, kernels, download)
     and whole write, host medians;
  5. the prediction path: reads of 300/500/700 bp sampled from the
     genomes, each classified to its source genome and every other read
     also to a second genome, predicted by the port's
     run_glimmer_mg_classes(device="cuda"). Checks: K1 launched, only
     overflow reads took the host route (at most 5%), the first reads'
     .predict text byte-identical to the exact host engine (the port's
     own copy of the pure numpy/Python per-read engine, engine/mg_host.py,
     run with engine="host"), finite scores, K3 (the event DP and
     traceback kernel) and KF (the frontend kernel) launched.
     Prints warm reads/s from a second pass, a third pass's wall time
     split by layer (chunk overlap off, as in every split), a pass with
     the f32 score carry, and a per-stage breakdown of one chunk, KF and
     its twin, K3 and its twin as separate stages; then K3 against its
     twin on the chunk's rows with the f64 and the f32 carry: bitwise
     equal on every output, no host sync (the call runs under
     torch.cuda.set_sync_debug_mode("error")), device time (CUDA events)
     beside the twin's and the bound; and KF against its twin on the
     chunk with each carry: every output bitwise equal (padding rows and
     n_events included), no host sync, K3 on KF's rows giving the genes
     of K3 on the twin's, device time beside the twin's and the bound;
  6. the pipeline path: the same reads as a FASTA file through the port's
     run_pipeline(device="cuda", iterate=0): classification against the
     512-ICM bank (K2), class parsing, prediction (K1). Checks: both
     kernels launched, 512 ICM rows in the raw matrix, the first class is
     the source genome for at least 90% of the reads, the first reads'
     scores within length/512 of the exact walk on the card and their
     .predict text byte-identical to the host engine on the same
     .class.txt, the prediction routing limits of phase 5. Prints the
     run's wall split by stage, and a warm classify_file call's reads/s,
     model-Mbp/s and wall split by layer;
  6b. stages 4-5: the same reads, upper case, through the port's
     run_pipeline(device="cuda", iterate=1) with a taxonomy that puts each
     decoy in its source genome's family, so init_clusters_from_results
     seeds one cluster a family: clustering with the device EM (the bank
     trainer on the card, then K2 on the freshly trained cluster bank,
     each iteration), then each cluster retrained and repredicted (K1).
     Checks: K2 launched in the EM and K1 in repredict, the first EM
     training on the card equal to the same code's on the CPU (counts,
     mutual information within 4 x 2^-23 x its terms' magnitude, mip but
     for printed near-ties, logged probs within 4 ulps), K2 in the EM
     bitwise equal to its twin on the last iteration's call (its tables,
     all of its reads), K1 in repredict bitwise equal to its twin on the
     inputs of the stage's call with the most bank rows (B, L and G
     printed), every read once in the final .predict, the largest
     cluster's first reads byte-identical to the host engine with that
     cluster's retrained models. Prints the clusters, the EM's iterations
     with each one's training (histograms among it) and K2 milliseconds
     (this run is probed: each call synchronised), the level-7 histogram's
     bytes and the level histogram (one bincount over masked keys) against
     the 11 index_add_ passes it replaced on the first training's level-7
     inputs, the host EM's agreement with the device EM on the first
     1,024 reads (a finding, not a gate), and a warm, unprobed run's wall
     split by stage, its repredict stage split into retraining and the
     rest;
  7. substitution mode: reads sampled as in phase 5 with 0.5%
     substitutions per base, two thirds with Phred 2-41 qualities,
     through run_glimmer_mg_classes(device="cuda", allow_subs=True,
     qualities=...). Checks: K1 launched, only overflow reads took the
     host route (at most 5%), the first reads' .predict text, substitution
     records included, byte-identical to the host engine, at least 1% of
     the genes carry a substitution record, K3 and KF (in its
     substitution mode) launched. Prints warm reads/s, a warm pass's wall
     split by layer and a per-stage breakdown of one chunk with phase 5's
     K3 and KF checks (qualities included; KF also on the same chunk
     without them, err_pos and err_typ among its outputs); K1 against its
     twin, bitwise, on the inputs of the path's K1 call with the most bank
     rows (B, L and G printed);
  8. indel mode: 454-like reads (homopolymer indels at 0.3% per base, no
     quality file) through run_glimmer_mg_classes(device="cuda",
     allow_indels=True): K1 on the card, then the native C++ engine on the
     host. Checks: K1 launched, every read counted in native_reads, the
     first 64 reads byte-identical to the host engine, K1 against its
     twin on the route's own inputs as in phase 7, KF launched 0 times.
     Prints warm reads/s and the engine's thread count;
  9. engine routes: phase 5's error-free reads and phase 7's substitution
     reads through run_glimmer_mg_classes(engine="native"), the native
     C++ engine on six-frame scores from K1 (precompute "device": packed
     on the card, copied into pinned memory) and on its own walk
     (precompute "host"). Checks: K1 launched, every read in
     native_reads and none on the host route, K1 bitwise equal to its
     twin on the route's widest call, every .predict byte-identical to
     the device route's on the same reads and the first 256 to the host
     engine, KF launched by the device route's passes (each mode). Prints
     warm reads/s of each route, the device route with the
     chunk overlap on and off, a native pass split by layer (K1's share
     among it) and the f64 score copy's ms for one chunk, pinned against
     pageable;
 10. the command line: python -m glimmer_mg_torch.cli as subprocesses on
     the card: glimmer-mg -c on phase 5's reads and classes (byte-
     identical to the API's output), classify (raw matrix byte-identical
     to phase 6's, its parsed classes equal to phase 6's .class.txt) and
     glimmer-mg-pipeline --iterate 0 --raw --cls resumed from a copy of
     phase 6's work directory (.predict byte-identical). Prints each
     call's wall time;
 11. the (data, model) mesh on torch.distributed (parallel.mesh): a world
     of 1 rank on NCCL in this process runs classify_file, scimm_cluster
     and run_pipeline(iterate=1) on a 1x1 mesh at the full width of phases
     6 and 6b (raw matrix and results table byte-identical to phase 6's,
     cluster files and every pipeline file to phase 6b's warm run); then
     2 ranks on the card (this script with --mesh-rank, started by
     parallel.launch.run_local, both on cuda:0 with gloo named as the
     backend: NCCL puts no two ranks on one card, so gloo takes the
     collectives through host memory while K1 and K2 run on the card) run
     classify_file on 1x2 and 2x1 meshes (files byte-identical to phase
     6's, in the ranks' one directory: rank 0 writes them on 1x2, each
     rank its share on 2x1), the device EM on 2x1 (cluster files
     byte-identical to phase 6b's) and data-sharded prediction of phase
     5's reads on 2x1 (each rank K1 and the event DP on its shard of the
     engine's chunks: records equal to the unsharded batches', the
     device-served reads' .predict byte-identical to phase 5's, the same
     overflow reads). Each rank's K2 on its last shard and K1 on its
     widest shard are held bitwise to their twins. Prints per-rank walls,
     K2 ms per shard (CUDA events) and gather and all-reduce ms (host
     clock), and no scaling figure: one card shows none;
 12. the port's bench (glimmer_mg_torch.bench) in this process, its cache
     in the smoke's temporary root: the bench DB (8 strains x 50 genes)
     and the seeded synthetic sample-run stand-in (a 1,800-gene genome at
     GC 0.39 with its g3-iterated files, 999 reads of 500 bp), then its
     four rows at the command line's widths: K2 on both strands at 16
     models x 512 reads x 510 bp and 256 x 128 (bitwise equal to its twin
     on the row's call; each shape's bound), gene_accuracy on 300 reads of
     500 bp through run_pipeline on the card (K1 and K2 launched;
     sensitivity and precision printed beside the JAX package's bar of
     0.90, only truth_genes > 100 gated), glimmer3 on the whole stand-in
     genome (byte-identical to its run1.predict), and reads/s on 8,192
     tiled reads x 2 timed passes (the command line's 100,000 x 5 would
     cost minutes on the device route): native engine on its own walk,
     on K1's scores (.predict byte-identical) and the device route with
     the f32 carry (coordinates identical), K1 launched on both. Prints
     each row's JSON, the stand-in's build seconds and the phase's.

K1's "launches" in the kernels record is the sum over the seven paths it
runs on (phases 5, 7, 8 and 9, each counted from zero around its first
pass or passes, the repredict stage of phase 6b's counted run, phase
11's pipeline and prediction, every rank's, and phase 12's accuracy and
reads/s rows), K2's the sum over classification (phase 6), the EM (phase
6b), phase 11's classification and EM and phase 12's bank-walk and
accuracy rows, K3's the sum over the paths that run the device route
(phases 5, 6, 6b's repredict, 7, 11's prediction and 12's accuracy and
device_resident rows), KF's the sum over the same paths and phase 9's
device-route passes of each mode (indel mode, phase 8, launches it 0
times, which it asserts); "launches_by_path" gives each. K3's and KF's
"ms", "plain_ms" and bound are those of phase 5's chunk (error-free,
f64); "cases" gives each mode and carry (KF: error_free, subs and
subs_quals, each f64 and f32; each KF case also names its instantiation
and gives its blocks an SM at the chunk's Lp, its registers and stack
frame (cuobjdump -res-usage), its spill bytes (ptxas, when the run built
the library) and its SASS BAR.SYNC count, null where the toolkit lacks
cuobjdump; each K3 case, error_free and subs_quals, f64 and f32, the
four instantiations, gives the longest read's steps, the microseconds a
step, the tables' length D and the same resources).
The raw-text kernel's "launches" is the sum over the paths that write a
raw matrix (phase 6's pipeline and warm classify_file, phase 6b's two
pipeline runs, phase 10's classify, phase 11's classify_file and
pipeline on the 1x1 mesh and every rank's classify_file, phase 12's
accuracy row), each counted from zero around its run and held to one
launch a raw matrix written; "launches_by_path" gives each. Phase 4c's
own timing runs are not counted.

``--kf-ab NAME=PATH`` runs KF alone instead (``kernel_ab``): this
checkout's csrc/frontend.cu beside another frontend source (the parent
commit's, say), each built as a library of its own, held bitwise to the
twin and timed in turns (A, B, B, A) at Lp 768 and 2,304, with their
resources. ``--k3-ab NAME=PATH`` does the same for K3 (csrc/event_dp.cu)
on this checkout's KF's rows of the same chunks.

The script imports only glimmer_mg_torch and checks at the end, after
the bench, that no module of JAX or of glimmer_mg_tpu was loaded.

Each kernel's bound is the larger of its bytes (inputs read once, outputs
written once) over the card's 3.35 TB/s and, for K1 and K2, its integer
instructions over
the card's INT32 rate (64 lanes an SM x SMs x the maximum SM clock that
nvidia-smi reports). The instructions are the walk's, counted in the SASS
of build/libglimmer_mg_torch.so (cuobjdump -sass, sm_90a): a count per
walk level, times the levels this run's walks enter (counted on the card),
plus a count per walk.

The third-to-last line is the card's name and power limit, the
second-to-last the kernels' JSON record, the last {"ok": true, "device":
{...}}. Without CUDA it raises before printing a result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
INT32_LANES_PER_SM = 64    # Hopper SM: 4 partitions x 16 INT32 lanes
# integer instructions of the walks in the SASS (cuobjdump -sass, sm_90a)
# of csrc/bank_walk.cu::walk_kernel<false, 7> and csrc/six_frame.cu::
# six_frame_kernel<int16_t, 7>: per level entered and per walk. K1's
# counts may only fall: a level issues 5 (its mut_info_pos from shared
# memory), a walk's prob address 5 (gene) or 3 (null), so 4 a walk; a
# position's context and stores take more than the 22 of the first
# design's least context (a shift and an or per base), which stays
K2_OPS_PER_LEVEL, K2_OPS_PER_WALK = 7, 22
K1_OPS_PER_LEVEL, K1_OPS_PER_WALK, K1_OPS_PER_POSITION = 5, 4, 22


def log(msg):
    print(msg, flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def int32_ops_per_s():
    """INT32 lanes x SMs x the card's maximum SM clock (nvidia-smi)."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_LANES_PER_SM * sms * mhz * 1e6


def bound(nbytes, ops):
    """(bound ms, "bytes" or "operations") of a kernel's work."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / int32_ops_per_s()
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def levels_entered(mip_at, depth, ctx, thresh, active):
    """Levels the ICM walk enters, summed over the ``active`` positions
    (a bool tensor of the walks' full shape): ``mip_at(k, node)`` is the
    mut_info_pos of each walk's node at level k; a walk enters level k
    when it did not stop before it."""
    import torch

    node = torch.zeros(active.shape, dtype=torch.int32, device=active.device)
    done = ~active
    total = 0
    for k in range(depth):
        total += int((~done).sum())
        pos = mip_at(k, node)
        avail = pos >= thresh
        b = (ctx >> (2 * pos.clamp(min=0))) & 3
        node = torch.where(done | ~avail, node, 4 * node + b + 1)
        done = done | ~avail
    return total


def bank_walk_levels(level_mip, reads, lengths, model_len, depth):
    """Levels K2's walks enter over one strand: every position < length of
    every read under every model, frame i % 3."""
    import torch

    from glimmer_mg_torch.ops import icm_cuda, icm_score

    m, _p, lr, lanes = level_mip.shape
    length = reads.shape[1]
    i = torch.arange(length, dtype=torch.int32, device=reads.device)
    ctx = icm_score.pack_contexts(reads, model_len)
    thresh = (model_len - 1 - i).clamp(min=0)
    valid = i[None, :] < lengths[:, None]
    starts, off = [], 0
    for k, rows in enumerate(icm_cuda._level_rows(depth)):
        starts.append(off * lanes - (4 ** k - 1) // 3)
        off += rows
    flat = level_mip.reshape(-1)
    total = 0
    for m0 in range(0, m, 64):
        models = torch.arange(m0, min(m, m0 + 64), device=reads.device)
        tab = (models[:, None, None] * 3 + (i % 3)) * (lr * lanes)
        active = valid.expand(len(models), *valid.shape)
        total += levels_entered(lambda k, node: flat[tab + starts[k] + node],
                                depth, ctx, thresh, active)
    return total


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


def sample_reads(genomes, n_reads, seed, lengths=(300, 500, 700)):
    """Reads of the three ``lengths`` in turn (300/500/700 bp) from random
    genome positions (half reverse-complemented); each classified to its
    source genome, every other read also to a second genome."""
    import numpy as np

    rng = np.random.default_rng(seed)
    names = list(genomes)
    comp = str.maketrans("acgt", "tgca")
    reads, cmap = [], {}
    for i in range(n_reads):
        src = int(rng.integers(len(names)))
        g = genomes[names[src]].lower()
        ln = lengths[i % 3]
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


def kernel_ms(fn, cold=False):
    """Device milliseconds of one launch of fn (a kernel launch with no
    host sync): warm, the median over 7 runs of 20 launches back to back
    between CUDA events; cold, the median of 11 single launches, each
    after a 64 MB write. Before each run the device sleeps for 1.5x the
    host time of the run's launches (measured once, at least ~0.1 ms), so
    that the host has enqueued them all before the first event is reached
    and the events see device time only, even for a wrapper whose host
    time is longer than its kernel's."""
    import torch

    flush = torch.empty(16 * 2 ** 20, dtype=torch.int32, device=DEVICE)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_s = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    n = 1 if cold else 20
    sleep = max(200_000, int(1.5 * n * host_s * 2e9))  # cycles, <= 2 GHz
    times = []
    for k in range(11 if cold else 7):
        if cold:
            flush.fill_(k)
        torch.cuda._sleep(sleep)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return sorted(times)[len(times) // 2]


def ptxas_lines(source, kernel):
    """ptxas's registers/shared-memory/spill lines of one kernel's
    instantiations in the last build of ``source``."""
    from glimmer_mg_torch import _build

    lines = _build.build_log.get(source, "").splitlines()
    out = []
    for k, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            name = line.split("'")[1]
            used = [x.split("ptxas info    :")[-1].strip()
                    for x in lines[k + 1:k + 4]
                    if "Used" in x or "spill" in x]
            out.append(f"{name}: {'; '.join(used)}")
    return out


KF_KERNEL = re.compile(r"frontend_kernelI([df])Lb([01])ELb([01])E([a-z])?")
K3_KERNEL = re.compile(r"event_dp_kernelI([df])Lb([01])E")


def kf_instantiation(name):
    """"f64_rbs_ef", "f32_norbs_subs_i16", ... of a mangled frontend_kernel
    name (the index type, where the kernel has one, last), or None."""
    m = KF_KERNEL.search(name)
    if not m:
        return None
    key = (("f64" if m[1] == "d" else "f32")
           + ("_rbs" if m[2] == "1" else "_norbs")
           + ("_subs" if m[3] == "1" else "_ef"))
    if m[4]:
        key += {"s": "_i16", "i": "_i32"}.get(m[4], "_" + m[4])
    return key


def k3_instantiation(name):
    """"f64_ef", "f32_subs", ... of a mangled event_dp_kernel name (the
    carry, then error-free rows or rows with error records), or None."""
    m = K3_KERNEL.search(name)
    if not m:
        return None
    return (("f64" if m[1] == "d" else "f32")
            + ("_subs" if m[2] == "1" else "_ef"))


def cuobjdump(*argv):
    """cuobjdump's output, or None where the toolkit has none."""
    from glimmer_mg_torch import _build

    exe = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(exe):
        return None
    out = subprocess.run([exe, *argv], capture_output=True, text=True)
    return out.stdout if out.returncode == 0 else None


def kernel_resources(so, ptxas_log="", key=kf_instantiation):
    """The instantiations of one kernel in the library ``so``, named by
    ``key`` (``kf_instantiation`` or ``k3_instantiation``, None for other
    kernels): registers and stack frame (cuobjdump -res-usage, else
    ptxas), ptxas's spill stores and loads (when ``ptxas_log`` has the
    build), and the static counts of BAR.SYNC, LDL and STL in the SASS
    (cuobjdump -sass); None where a tool or log is missing."""
    res = collections.defaultdict(lambda: dict.fromkeys(
        ("regs", "stack_bytes", "spill_bytes", "bar_sync", "ldl", "stl")))
    fn = None
    for line in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = key(m[1])
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            res[fn]["stack_bytes"] = int(m[1])
            res[fn]["spill_bytes"] = int(m[2]) + int(m[3])
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            res[fn]["regs"] = int(m[1])
    usage = cuobjdump("-res-usage", so) or ""
    for line in usage.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = key(m[1])
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+)", line)
        if m and fn:
            res[fn]["regs"], res[fn]["stack_bytes"] = int(m[1]), int(m[2])
    sass = cuobjdump("-sass", so)
    fn = None
    for line in (sass or "").splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = key(m[1])
            if fn:
                res[fn].update(bar_sync=0, ldl=0, stl=0)
            continue
        if fn:
            for k, pat in (("bar_sync", r"\bBAR\.SYNC"),
                           ("ldl", r"\bLDL\b"), ("stl", r"\bSTL\b")):
                if re.search(pat, line):
                    res[fn][k] += 1
    return dict(res)


@contextlib.contextmanager
def ab_library(cdll):
    """The kernel wrappers launching from ``cdll`` (a library of one
    kernel source, KF's or K3's) for the duration."""
    from glimmer_mg_torch import _build
    from glimmer_mg_torch.ops import frontend_cuda

    old = _build.lib()
    _build._LIB = cdll
    frontend_cuda._ROOM.clear()
    frontend_cuda._OCC.clear()
    try:
        yield
    finally:
        _build._LIB = old
        frontend_cuda._ROOM.clear()
        frontend_cuda._OCC.clear()


# --kf-ab / --k3-ab: the kernel's source in csrc, the binder of its C
# entries in _build, the namer of its instantiations
AB_KERNELS = {"kf": ("frontend.cu", "bind_frontend", kf_instantiation),
              "k3": ("event_dp.cu", "bind_event_dp", k3_instantiation)}


def ab_libraries(kind, sources):
    """This checkout's source of kernel ``kind`` ("this") and each
    NAME=PATH of ``sources``, each built alone into a library of its own
    (nvcc with the build's flags, all at once), bound and loaded, with
    each instantiation's resources (``kernel_resources``)."""
    import ctypes

    from glimmer_mg_torch import _build

    source, binder, key = AB_KERNELS[kind]
    specs = [("this", str(_build.CSRC_DIR / source))]
    specs += [tuple(x.split("=", 1)) for x in sources]
    out_dir = _build.BUILD_DIR / f"{kind}_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    t0 = time.perf_counter()
    logs = _build._run([[nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v",
                         "-shared", "-o", str(out_dir / f"{n}.so"), src]
                        for n, src in specs])
    log(f"{kind}-ab: {len(logs)} libraries built in "
        f"{time.perf_counter() - t0:.1f} s")
    libs = {}
    for (name, src), text in zip(specs, logs):
        so = str(out_dir / f"{name}.so")
        cdll = ctypes.CDLL(so)
        getattr(_build, binder)(cdll)
        libs[name] = {"source": src, "cdll": cdll,
                      "resources": kernel_resources(so, text, key),
                      "cases": {}}
        for k, r in sorted(libs[name]["resources"].items()):
            log(f"{kind}-ab {name} {k}: {json.dumps(r)}")
    return libs


def ab_chunks(args):
    """The A/B harness's chunks: phase 5's and phase 7's 2,048 reads at
    Lp 768, and 2,048 reads of 1,100-2,250 bp from the same genomes at Lp
    2,304 (the card tests' long shape), each in the six cases of the
    kernels line (and error-free f64 with the RBS term off at Lp 768):
    case name -> (the frontend's arguments, its qualities or None, the
    bank's tables on the card)."""
    import torch

    from glimmer_mg_torch.ops import device_predict as dpk
    from glimmer_mg_torch.ops import icm_cuda

    cases = {}
    with tempfile.TemporaryDirectory(prefix="gmt_ab_") as root:
        gd, genomes = build_database(root, args.genome_kb, args.seed)
        for Lp, lengths in ((768, (300, 500, 700)),
                            (2304, (1100, 1700, 2250))):
            reads, cmap = sample_reads(genomes, 2048, args.seed + 3,
                                       lengths)
            sreads, scmap = sample_reads(genomes, 2048, args.seed + 11,
                                         lengths)
            sreads, quals = with_substitutions(sreads, 0.005, args.seed + 12)
            for mode, rd, cm, q, subs in (
                    ("error_free", reads, cmap, None, False),
                    ("subs", sreads, scmap, None, True),
                    ("subs_quals", sreads, scmap, quals, True)):
                bank, dev, reads_t, lens, grp, q_t, consts = chunk_inputs(
                    gd, rd, cm, q, subs, Lp)
                g6, i6 = icm_cuda.mg_six_frame(
                    dev["gene_mip"], dev["gene_probs"], dev["indep_mip"],
                    dev["indep_probs"], reads_t, lens, grp,
                    model_len=bank.model_len, depth=bank.depth)
                fargs = (reads_t, lens, grp, g6, i6, dev, Lp)
                for fdt, carry in ((torch.float64, "f64"),
                                   (torch.float32, "f32")):
                    cases[f"{mode}_{carry}_lp{Lp}"] = (
                        fargs + (dict(consts, fdt=fdt), dpk.MAX_EVENTS), q_t)
                if mode == "error_free" and Lp == 768:
                    cases["error_free_f64_norbs_lp768"] = (
                        fargs + (dict(consts, W=0), dpk.MAX_EVENTS), None)
    return cases


def kf_ab_case(fargs, q):
    """KF's case in the A/B harness: (the wrapper call, the twin's
    output, how a library's output differs from it, the case's facts)."""
    import torch

    from glimmer_mg_torch.ops import frontend, frontend_cuda

    device = torch.device(DEVICE, torch.cuda.current_device())
    want = frontend.frontend(*fargs, quals=q)
    Lp, consts = fargs[6], fargs[7]
    f64 = consts["fdt"] == torch.float64
    rbs, subs = consts["W"] > 0, bool(consts.get("subs"))
    info = {"n_events": int(want[1].sum()),
            "ws_bytes": frontend_cuda.workspace_bytes(Lp, f64, subs),
            "smem_room": frontend_cuda._smem_room(device, f64, rbs, subs),
            "blocks_per_sm": frontend_cuda.blocks_per_sm(Lp, f64, rbs, subs)}
    return (lambda: frontend_cuda.frontend(*fargs, quals=q),
            lambda got: kf_differs(want, got), info)


def k3_ab_case(fargs, q):
    """K3's case in the A/B harness: its rows are this checkout's KF's on
    the chunk (the main path's), its twin ``event_dp.event_dp_traceback``;
    the facts: the longest read's steps, E, D, the events, and the
    wrapper's host milliseconds (synchronised; the wrapper is this
    checkout's for every library)."""
    import torch

    from glimmer_mg_torch.ops import device_predict as dpk
    from glimmer_mg_torch.ops import event_dp, event_dp_cuda, frontend_cuda

    grp, dev, consts = fargs[2], fargs[5], fargs[7]
    ev, n = frontend_cuda.frontend(*fargs, quals=q)
    ne = torch.clamp(n, max=dpk.MAX_EVENTS)
    tables = {k: dev[k] for k in ("adj_or", "adj_dist", "adj_dist_len")}
    k3args = (ev, tables, grp, consts, ne)
    want = event_dp.event_dp_traceback(
        ev, event_dp._prefetch_adj(dev, grp), consts, ne)

    def call():
        return event_dp_cuda.event_dp_traceback(*k3args)

    def synced():
        call()
        torch.cuda.synchronize()
    synced()
    info = {"steps": int(ne.max()), "E": ev["pos"].shape[1],
            "D": tables["adj_dist"].shape[-1], "n_events": int(ne.sum()),
            "wrapper_host_ms": host_ms(synced, reps=21)}
    return call, lambda got: k3_differs(want, got), info


def kernel_ab(kind, sources, args):
    """--kf-ab / --k3-ab NAME=PATH (repeatable): KF or K3 alone, the
    library of this checkout's source ("this") beside one of each named
    source (``ab_libraries``), each launched through this checkout's
    wrapper on the chunks of ``ab_chunks`` (K3 on this checkout's KF's
    rows of them, without the RBS-off case). Every library is held
    bitwise to the twin in every case, then timed (``kernel_ms``) in the
    order of the libraries and in reverse (A, B, B, A). Prints the record
    as one JSON line; raises, after it, if a library differs from the
    twin."""
    import torch

    from glimmer_mg_torch import _build

    libs = ab_libraries(kind, sources)
    _build.build()
    _build.lib()
    names = list(libs)
    for cname, (fargs, q) in ab_chunks(args).items():
        if kind == "k3" and "norbs" in cname:
            continue
        call, differs, info = (kf_ab_case if kind == "kf"
                               else k3_ab_case)(fargs, q)
        for name in names:
            with ab_library(libs[name]["cdll"]):
                got = call()
                torch.cuda.synchronize()
                libs[name]["cases"][cname] = {"differs": differs(got),
                                              "ms": [], **info}
            del got
        for name in names + names[::-1]:
            with ab_library(libs[name]["cdll"]):
                libs[name]["cases"][cname]["ms"].append(kernel_ms(call))
        log(f"{kind}-ab {cname}: " + ", ".join(
            f"{n} {libs[n]['cases'][cname]['ms']}"
            + ("" if libs[n]["cases"][cname]["differs"] is None
               else f" DIFFERS ({libs[n]['cases'][cname]['differs']})")
            for n in names) + f"; {json.dumps(info)} [{gpu_line()}]")
    for rec in libs.values():
        del rec["cdll"]
    print(gpu_line())
    print(json.dumps({f"{kind}_ab": libs}))
    bad = [(n, c) for n in names for c, r in libs[n]["cases"].items()
           if r["differs"] is not None]
    assert not bad, f"{kind.upper()} differs from its twin: {bad}"


def sixframe_phase(gd, genomes, seed):
    """K1 vs its twin at the main path's shapes; returns its record."""
    import numpy as np
    import torch

    from glimmer_mg_torch import _build
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
    # the folded tables, made once per bank as engine/glimmer_mg.py does
    folded = (icm_cuda.fold_pruned_probs(dev["gene_mip"], dev["gene_probs"]),
              icm_cuda.fold_pruned_probs(dev["indep_mip"],
                                         dev["indep_probs"]))
    kw = dict(model_len=bank.model_len, depth=bank.depth)

    icm_cuda.reset_launches()
    kg, ki = icm_cuda.mg_six_frame(*args, **kw, folded=folded)
    torch.cuda.synchronize()
    assert icm_cuda.launches == 1
    tg, ti = icm_score.mg_six_frame_batch(*args, **kw)
    torch.cuda.synchronize()
    bitwise = (torch.equal(kg.view(torch.int32), tg.view(torch.int32))
               and torch.equal(ki.view(torch.int32), ti.view(torch.int32)))
    err = max(float((kg - tg).abs().max()), float((ki - ti).abs().max()))
    if not bitwise:
        raise AssertionError(f"six_frame kernel differs from twin ({err})")
    # the wrapper call as the main path makes it (index ranges checked on
    # the host before the upload, so no host sync, then the launch), the
    # call with the device range check (one host sync), and the kernel's
    # own device time
    icm_cuda.check_tables(bank.gene_mip, bank.indep_mip, bank.depth)
    icm_cuda.check_reads(reads, lens, grp, 16)
    ms = cuda_ms(lambda: icm_cuda.mg_six_frame(*args, **kw, folded=folded,
                                               ranges_checked=True), reps=11)
    checked_ms = cuda_ms(lambda: icm_cuda.mg_six_frame(*args, **kw,
                                                       folded=folded),
                         reps=11)
    launch_args = (dev["gene_mip"], folded[0], dev["indep_mip"], folded[1],
                   *t, bank.model_len, bank.depth)
    dev_ms = kernel_ms(lambda: icm_cuda._launch_six_frame(*launch_args))
    dev_cold_ms = kernel_ms(lambda: icm_cuda._launch_six_frame(*launch_args),
                            cold=True)
    plain_ms = cuda_ms(lambda: icm_score.mg_six_frame_batch(*args, **kw))
    log("K1 staging: one read a block; gene-tree levels 0..depth-1 and the "
        "null ICM in shared memory")
    for line in (ptxas_lines("six_frame", "six_frame_kernelIsLi7E")
                 or ["not compiled in this process (build/ was current)"]):
        log(f"ptxas (int16 mip, depth 7): {line}")
    smem = _build.lib().gmt_six_frame_smem(bank.depth, L)
    log(f"K1 dynamic shared memory a block: {smem} B")

    # bound: every (read, variant, position) walks the gene ICM and the
    # null ICM in 3 frames; the outputs are 2 x (B, 6, L) f32
    nbytes = (sum(x.numel() * x.element_size() for x in args)
              + 2 * kg.numel() * 4)
    i = torch.arange(L, dtype=torch.int32, device=DEVICE)
    active = torch.ones((B, L), dtype=torch.bool, device=DEVICE)
    g, p, n = dev["gene_mip"].shape
    n2 = dev["indep_mip"].shape[2]
    gm = dev["gene_mip"].reshape(-1).to(torch.int32)
    im = dev["indep_mip"].reshape(-1).to(torch.int32)
    grp = t[2].long()[:, None]
    levels = 0
    for seq in icm_score.read_variants(t[0], t[1]):
        ctx = icm_score.pack_contexts(seq, bank.model_len)
        ctx_null = icm_score.pack_contexts(seq, 3)
        for f in range(3):
            goff = (grp * p + f % p) * n
            ioff = (grp * 3 + f) * n2
            levels += levels_entered(
                lambda k, node: gm[goff + node], bank.depth, ctx,
                (bank.model_len - 1 - i).clamp(min=0), active)
            levels += levels_entered(lambda k, node: im[ioff + node], 2,
                                     ctx_null, (2 - i).clamp(min=0), active)
    walks = 2 * 2 * 3 * B * L
    ops = (levels * K1_OPS_PER_LEVEL + walks * K1_OPS_PER_WALK
           + 2 * B * L * K1_OPS_PER_POSITION)
    bound_ms, bound_by = bound(nbytes, ops)
    log(f"K1 six_frame vs twin at B={B} L={L} G=16 depth={bank.depth}: "
        f"bitwise equal; wrapper call {ms:.4f} ms as the engine makes it "
        f"(ranges checked on the host), {checked_ms:.4f} ms with the device "
        f"range check; kernel device time "
        f"{dev_ms:.4f} ms warm, {dev_cold_ms:.4f} ms L2-cold; twin {plain_ms:.4f} ms (medians, CUDA events); bound "
        f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
        f"{ops / 1e9:.3f} G integer instructions: {walks} walks entering "
        f"{levels} levels); share of bound: wrapper {bound_ms / ms:.3f}, "
        f"kernel {bound_ms / dev_ms:.3f} [{gpu_line()}]")
    return {"name": "six_frame", "route": "cuda",
            "source": "glimmer_mg_torch/csrc/six_frame.cu",
            "replaces": "glimmer_mg_tpu/ops/icm_pallas.py:402",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "kernel_ms": dev_ms, "kernel_ms_cold": dev_cold_ms,
            "checked_ms": checked_ms}


def bankwalk_phase(bank, genomes, seed):
    """K2 vs its twin at one classification batch of the full bank (B 512
    x L 702 x all ICMs), one strand and both strands in one launch, then
    K2 over 8-bit tables vs its twin; returns the records of both."""
    import numpy as np
    import torch

    from glimmer_mg_torch.ops import icm_cuda, icm_score
    from glimmer_mg_torch.parallel.classify import pad_reads

    sample, _ = sample_reads(genomes, 512, seed + 4)
    reads_np, lengths_np = pad_reads([s for _h, s in sample], length=702)
    reads = torch.from_numpy(reads_np).to(DEVICE)
    lengths = torch.from_numpy(lengths_np).to(DEVICE)
    rc = icm_score.revcomp_reads(reads, lengths)
    lm, pk = bank.tables
    m = lm.shape[0]
    shape = (bank.model_len, bank.depth)

    def kernel(tables, strands, **kw):
        fn = (icm_cuda.bank_score_reads_kernel if strands == 1
              else icm_cuda.bank_score_both_strands)
        return fn(*tables, reads, lengths, *shape, **kw)

    def twin(tables, strands, **kw):
        fwd = icm_score.bank_score_reads_packed(*tables, reads, lengths,
                                                *shape, **kw)
        if strands == 1:
            return fwd
        return torch.maximum(fwd, icm_score.bank_score_reads_packed(
            *tables, rc, lengths, *shape, **kw))

    levels = [bank_walk_levels(lm, r, lengths, *shape) for r in (reads, rc)]
    positions = int(lengths.sum())
    io_bytes = (reads.numel() + lengths.numel() + reads.shape[0] * m) * 4
    model_mbp = positions * m / 1e6
    # 8-bit tables, packed 16 models at a time as PhymmBank packs them
    parts = [icm_cuda.pack_tables_int8(bank.mip[i:i + 16],
                                       bank.probs[i:i + 16], depth=bank.depth)
             for i in range(0, m, 16)]
    tables8 = tuple(torch.from_numpy(np.concatenate(
        [pt[j] for pt in parts])).to(DEVICE) for j in (0, 1))
    assert torch.equal(tables8[0], lm)  # the same level tables
    results = {}
    for name, tables, kw, strands_list in (
            ("fixed16", (lm, pk), {}, (1, 2)),
            ("int8", tables8, {"int8": True, "scale": parts[0][2]}, (1,))):
        table_bytes = sum(x.numel() * x.element_size() for x in tables)
        for strands in strands_list:
            icm_cuda.reset_launches()
            got = kernel(tables, strands, **kw)
            torch.cuda.synchronize()
            assert (icm_cuda.bank_walk_launches
                    + icm_cuda.bank_walk_int8_launches) == 1
            want = twin(tables, strands, **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"bank_walk {name} x {strands} strands "
                                     f"differs from its twin ({err})")
            assert bool(torch.isfinite(got).all()) and bool((got <= 0).all())
            ms = cuda_ms(lambda: kernel(tables, strands, **kw), reps=11)
            plain_ms = cuda_ms(lambda: twin(tables, strands, **kw), reps=3)
            lv = sum(levels[:strands])
            walks = strands * m * positions
            ops = lv * K2_OPS_PER_LEVEL + walks * K2_OPS_PER_WALK
            bound_ms, bound_by = bound(table_bytes + io_bytes, ops)
            log(f"K2 bank_walk {name}, {strands} strand(s), vs twin at "
                f"B=512 L=702 M={m} depth={bank.depth}: bitwise equal; "
                f"kernel {ms:.4f} ms (median of 11), twin {plain_ms:.4f} ms "
                f"(median of 3), CUDA events; "
                f"{strands * model_mbp / (ms / 1e3):.1f} model-Mbp/s; bound "
                f"{bound_ms:.4f} ms by {bound_by} ({table_bytes / 1e6:.1f} MB "
                f"of tables, {ops / 1e9:.3f} G integer instructions: {walks} "
                f"walks entering {lv} levels) [{gpu_line()}]")
            results[name, strands] = {"max_abs_err": err, "ms": ms,
                                      "plain_ms": plain_ms,
                                      "bound_ms": bound_ms,
                                      "bound_by": bound_by,
                                      "library_ms": None}
    # the main path runs the fixed16 kernel on both strands at once
    return ({"name": "bank_walk", "route": "cuda",
             "source": "glimmer_mg_torch/csrc/bank_walk.cu",
             "replaces": "glimmer_mg_tpu/ops/icm_pallas.py:201",
             **results["fixed16", 2]},
            {"name": "bank_walk_int8", "route": "cuda",
             "source": "glimmer_mg_torch/csrc/bank_walk.cu",
             "replaces": "glimmer_mg_tpu/ops/icm_pallas.py:251",
             **results["int8", 1]})


def rawtext_phase(seed, n=16384, m=539):
    """The raw-text kernel at one classified file's shape (16,384 reads x
    539 ICMs of log-probability-sized scores): bytes equal to its plain
    version; the four kernels' device time warm and L2-cold, the measure
    pass's alone, beside the bound (the matrix read once and the text
    written once over 3.35 TB/s); the plain version's host time; and the
    writer's whole ``.text`` part (the upload, the kernels, the sync for
    the length and the download into pinned memory), its upload alone,
    and the whole writer into a file, host medians. Returns the kernel's
    record."""
    import numpy as np
    import torch

    from glimmer_mg_torch import _build
    from glimmer_mg_torch.ops import raw_text_cuda
    from glimmer_mg_torch.parallel import phymm

    rng = np.random.default_rng(seed + 19)
    a = (-rng.uniform(250.0, 1600.0, size=(n, m))).astype(np.float32)
    a[0, :4] = [-0.0, 1 / 32, np.nan, -np.inf]
    raw_text_cuda.reset_launches()
    dev = torch.from_numpy(a).to(DEVICE)
    got = bytes(raw_text_cuda.rows_text(dev))
    assert raw_text_cuda.launches == 1
    t0 = time.perf_counter()
    want = raw_text_cuda.plain_rows(a).encode("ascii")
    plain_ms = (time.perf_counter() - t0) * 1e3
    if got != want:
        raise AssertionError(f"raw_text differs from its plain version "
                             f"({len(got)} / {len(want)} bytes)")
    lib = _build.lib()
    stream = torch.cuda.current_stream().cuda_stream
    tiles = -(-n // lib.gmt_raw_text_tile_reads())
    tile_len = torch.empty(m * tiles, dtype=torch.int32, device=DEVICE)
    row_off = torch.empty(m + 1, dtype=torch.int64, device=DEVICE)
    out = torch.empty(len(got), dtype=torch.uint8, device=DEVICE)

    def measure():
        lib.gmt_raw_text_measure(dev.data_ptr(), n, m, tile_len.data_ptr(),
                                 row_off.data_ptr(), stream)

    def both():
        measure()
        lib.gmt_raw_text_write(dev.data_ptr(), n, m, tile_len.data_ptr(),
                               row_off.data_ptr(), out.data_ptr(), stream)

    ms = kernel_ms(both)
    cold_ms = kernel_ms(both, cold=True)
    measure_ms = kernel_ms(measure)
    torch.cuda.synchronize()
    assert bytes(out.cpu().numpy()) == got
    bound_ms, bound_by = bound(a.nbytes + len(got), 0)

    def text_part():
        return raw_text_cuda.rows_text(torch.from_numpy(a).to(DEVICE))

    text_ms = host_ms(text_part)
    upload_ms = host_ms(lambda: (torch.from_numpy(a).to(DEVICE),
                                 torch.cuda.synchronize()))
    with tempfile.TemporaryDirectory() as tmp:
        paths = [f"/db/strain{k}/nc{k}.icm" for k in range(m)]
        ids = [f"read{i}" for i in range(n)]
        writer_ms = host_ms(lambda: phymm.write_raw_phymm_output(
            os.path.join(tmp, "raw.txt"), paths, ids, a), reps=3)
    for line in ptxas_lines("raw_text", "_kernel"):
        log(f"raw_text ptxas: {line}")
    log(f"raw_text at {n} x {m} ({a.nbytes / 1e6:.1f} MB in, "
        f"{len(got) / 1e6:.1f} MB of text): byte-identical to plain_rows; "
        f"four kernels {ms:.4f} ms warm, {cold_ms:.4f} ms L2-cold (device, "
        f"CUDA events), the measure pass {measure_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by}; plain_rows {plain_ms:.1f} ms; "
        f"the writer's .text part {text_ms:.2f} ms (its upload "
        f"{upload_ms:.2f} ms), the whole writer into a file "
        f"{writer_ms:.2f} ms (host medians) [{gpu_line()}]")
    return {"name": "raw_text", "route": "cuda",
            "source": "glimmer_mg_torch/csrc/raw_text.cu",
            "replaces": None, "max_abs_err": 0.0, "ms": ms,
            "kernel_ms_cold": cold_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "cases": {"measure_ms": measure_ms, "text_part_ms": text_ms,
                      "upload_ms": upload_ms, "writer_ms": writer_ms,
                      "text_bytes": len(got)}}


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


@contextlib.contextmanager
def overlap(value):
    """For the block, the engine's chunk overlap on ("1"), off ("0") or
    as its default rule decides (None)."""
    saved = os.environ.get("GLIMMER_MG_TPU_OVERLAP")
    if value is not None:
        os.environ["GLIMMER_MG_TPU_OVERLAP"] = value
    try:
        yield
    finally:
        os.environ.pop("GLIMMER_MG_TPU_OVERLAP", None)
        if saved is not None:
            os.environ["GLIMMER_MG_TPU_OVERLAP"] = saved


def timed_pass(gd, reads, cmap, want, title="timed warm pass", **kw):
    """One more warm pass (run_glimmer_mg_classes options ``kw``) with its
    host-clock time split by layer, with the chunk overlap off so that
    the layers run one after another; the parts add up to the pass's wall
    time ("other": encoding, emission order, padding, uploads). On the
    native route "frame_dispatch" is the six-frame scores' launch half
    without K1 and the frame bank (packing, the pinned copy's launch),
    "frame_finish" the wait for the copy and the cut. Returns (wall,
    parts)."""
    import torch

    from glimmer_mg_torch import native
    from glimmer_mg_torch.engine import glimmer_mg as tmg
    from glimmer_mg_torch.ops import device_predict as dpk
    from glimmer_mg_torch.ops import icm_cuda

    stages = [(tmg, "classes_models", "models", False),
              (tmg, "_bank_for", "bank", False),
              (tmg, "_frame_bank_for", "frame_bank", False),
              (icm_cuda, "mg_six_frame", "six_frame", True),
              (tmg, "_frame_scores_dispatch", "frame_dispatch", True),
              (tmg, "_frame_scores_finish", "frame_finish", False),
              (dpk, "predict_batch_device", "frontend_dp_traceback", True),
              (dpk, "finish_genes", "finish_genes", False),
              (native, "predict_batch", "native_engine", False),
              (tmg, "_host_predict", "host_engine", False)]
    with overlap("0"), wrapped_parts(stages) as parts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = list(tmg.run_glimmer_mg_classes(reads, gd, cmap,
                                              device=DEVICE, **kw))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    assert tmg.format_predict_mg(got) == tmg.format_predict_mg(want)
    # the dispatch half holds the K1 call and the frame bank: count each once
    if "frame_dispatch" in parts:
        parts["frame_dispatch"] -= (parts.get("six_frame", 0.0)
                                    + parts.get("frame_bank", 0.0))
    log_parts(f"{title}: {len(reads)} reads", wall, parts)
    return wall, parts


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


def k3_bytes(ev, tables, B):
    """Bytes K3 must move for one call: each input read once (the event
    rows, ne, groups, the bank's adjacency tables), each output written
    once (score and bp rows, best, wovf, the gene records, cnt)."""
    sb = ev["score"].element_size()
    E = ev["pos"].shape[1]
    row = 4 * 4 + sb + 1 + (8 if "err_pos" in ev else 0)
    inputs = B * E * row + 2 * 4 * B + sum(t.nbytes for t in tables.values())
    outputs = (B * E * (sb + 4) + B * (6 * 4 + 1 + 4)
               + B * 48 * (6 * 4 + 1 + sb))
    return inputs + outputs


K3_OUT = ("score bp best wovf g_id g_stop g_len g_sign g_trunc g_score "
          "g_epos g_etyp cnt").split()


def k3_differs(want, got):
    """The first of K3's outputs (``K3_OUT``) that is not bitwise equal to
    the twin's, or None."""
    import torch

    for name, a, b in zip(K3_OUT, want, got):
        if a.dtype.is_floating_point:
            iv = torch.int64 if a.dtype == torch.float64 else torch.int32
            a, b = a.view(iv), b.view(iv)
        if a.shape != b.shape or not torch.equal(a, b):
            return name
    return None


_K3_RESOURCES: dict = {}


def k3_case_resources(ev):
    """The instantiation K3 runs on event rows ``ev`` and, from the kernel
    library of this run (``kernel_resources``), its registers, stack
    frame, spill bytes (when this process built the library) and SASS
    BAR.SYNC count."""
    import torch

    from glimmer_mg_torch import _build

    if not _K3_RESOURCES:
        _K3_RESOURCES.update(kernel_resources(
            str(_build.LIB_PATH), _build.build_log.get("event_dp", ""),
            k3_instantiation))
    key = (("f64" if ev["score"].dtype == torch.float64 else "f32")
           + ("_subs" if ev.get("err_pos") is not None else "_ef"))
    res = _K3_RESOURCES.get(key, {})
    return {"instantiation": key,
            **{k: res.get(k) for k in ("regs", "stack_bytes", "spill_bytes",
                                       "bar_sync")}}


def k3_check(title, ev, dev, grp, consts, ne):
    """K3 against its twin on one chunk's rows: bitwise on every output,
    no host sync (the call runs under sync debug mode "error"), its device
    time (CUDA events), the longest read's steps and microseconds a step,
    the twin's time, the instantiation's resources; returns K3's case
    record."""
    import torch

    from glimmer_mg_torch.ops import event_dp, event_dp_cuda

    tables = {k: dev[k] for k in ("adj_or", "adj_dist", "adj_dist_len")}
    args = (ev, tables, grp, consts, ne)
    event_dp_cuda.event_dp_traceback(*args)  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = event_dp_cuda.event_dp_traceback(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    adj = event_dp._prefetch_adj(dev, grp)
    want = event_dp.event_dp_traceback(ev, adj, consts, ne)
    syncs = event_dp.last_syncs
    bad = k3_differs(want, got)
    assert bad is None, f"K3 {bad} differs from its twin ({title})"
    diff = (want[0] - got[0]).abs()
    diff = diff[torch.isfinite(diff)]
    err = float(diff.max()) if diff.numel() else 0.0
    ms = kernel_ms(lambda: event_dp_cuda.event_dp_traceback(*args))
    plain = cuda_ms(lambda: event_dp.event_dp_traceback(ev, adj, consts, ne),
                    reps=3)
    nbytes = k3_bytes(ev, tables, ne.shape[0])
    bound_ms, by = bound(nbytes, 0)
    steps = int(ne.max())
    res = {"steps": steps, "us_per_step": ms * 1e3 / max(steps, 1),
           "D": tables["adj_dist"].shape[-1], **k3_case_resources(ev)}
    log(f"K3 {title}: B {ne.shape[0]} x E {ev['pos'].shape[1]}, "
        f"{steps} steps; bitwise equal to its twin, K3 host syncs 0 (sync "
        f"debug mode error), the twin's {syncs}; K3 {ms:.4f} ms (device, "
        f"CUDA events), twin {plain:.4f} ms; bound {bound_ms:.4f} ms "
        f"({nbytes / 1e6:.3f} MB over 3.35 TB/s); {json.dumps(res)} "
        f"[{gpu_line()}]")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": by, "max_abs_err": err, **res}


# K3's records: its launches on each path (phases fill "paths") and its
# time on the smoke's chunk in each mode and carry ("cases").
K3 = {"paths": {}, "cases": {}}
# KF's records, the same for the frontend kernel.
KF = {"paths": {}, "cases": {}}
# The raw-text kernel's launches on each path that writes a raw matrix.
RAW_TEXT = {}


@contextlib.contextmanager
def raw_matrices():
    """For the block, the raw matrices written (write_raw_phymm_output's
    calls) and the raw-text kernel's launches, both counted from zero;
    yields {"written": n, "launches": k}, filled in when the block ends."""
    from glimmer_mg_torch.ops import raw_text_cuda
    from glimmer_mg_torch.parallel import phymm

    rec = {"written": 0, "launches": 0}
    real = phymm.write_raw_phymm_output

    def counted(*a, **k):
        rec["written"] += 1
        return real(*a, **k)

    raw_text_cuda.reset_launches()
    phymm.write_raw_phymm_output = counted
    try:
        yield rec
    finally:
        phymm.write_raw_phymm_output = real
        rec["launches"] = raw_text_cuda.launches


def count_raw_text(path, rec):
    """Adds a path's raw-text launches to RAW_TEXT, asserting that it
    wrote a raw matrix and that the kernel rendered each one."""
    log(f"{path}: {rec['written']} raw matrices written, raw-text kernel "
        f"launches {rec['launches']}")
    assert rec["written"] >= 1, f"{path} wrote no raw matrix"
    assert rec["launches"] == rec["written"], \
        f"{path}: the raw-text kernel did not render every raw matrix {rec}"
    RAW_TEXT[path] = RAW_TEXT.get(path, 0) + rec["launches"]


def kf_bytes(args, ev, quals=None):
    """Bytes KF must move for one call: each input read once (the reads,
    lengths, groups, the bank tables it reads, and of K1's two six-frame
    tables only the positions below each read's length, the only ones KF
    reads; in substitution mode the quality matrix and _CP_TAB, when
    given), each output written once (the event rows, with err_pos and
    err_typ in substitution mode, and n_events)."""
    seq, n, gi, g6, i6, bank = args[:6]
    Lp = args[6]
    tables = ("fwd_start rev_start fwd_stop rev_stop which_fwd which_rev "
              "prior start_lo len_score ignore_score_len pwm_cols pwm_n "
              "pwm_user pwm_is_user gc_lp").split()
    live = int(n.clamp(0, Lp).sum())
    inputs = sum(t.nbytes for t in (seq, n, gi))
    inputs += 2 * 6 * g6.element_size() * live
    inputs += sum(bank[k].nbytes for k in tables)
    if quals is not None:
        inputs += quals.nbytes + 256 * 8
    return inputs + sum(t.nbytes for t in ev.values()) + n.nbytes


_KF_RESOURCES: dict = {}


def kf_case_resources(args):
    """The instantiation KF runs on a chunk (``args`` the frontend's
    arguments): its blocks an SM at the chunk's Lp and, from the kernel
    library of this run (``kernel_resources``), its registers, stack frame,
    spill bytes (when this process built the library) and SASS
    BAR.SYNC count."""
    import torch

    from glimmer_mg_torch import _build
    from glimmer_mg_torch.ops import frontend_cuda

    if not _KF_RESOURCES:
        _KF_RESOURCES.update(kernel_resources(
            str(_build.LIB_PATH), _build.build_log.get("frontend", "")))
    Lp, consts = args[6], args[7]
    f64, rbs = consts["fdt"] == torch.float64, consts["W"] > 0
    subs = bool(consts.get("subs"))
    key = (f"{'f64' if f64 else 'f32'}_{'rbs' if rbs else 'norbs'}_"
           f"{'subs' if subs else 'ef'}_"
           f"{'i16' if Lp < frontend_cuda.narrow_lp() else 'i32'}")
    res = _KF_RESOURCES.get(key, {})
    return {"instantiation": key,
            "blocks_per_sm": frontend_cuda.blocks_per_sm(Lp, f64, rbs, subs),
            **{k: res.get(k) for k in ("regs", "stack_bytes", "spill_bytes",
                                       "bar_sync")}}


def kf_differs(want, got):
    """The first of KF's outputs (n_events, then the event rows) that is
    not bitwise equal to the twin's, or None."""
    import torch

    (wev, wn), (gev, gn) = want, got
    if not torch.equal(wn, gn):
        return "n_events"
    if set(wev) != set(gev):
        return f"row set {sorted(wev)} / {sorted(gev)}"
    for k, a in wev.items():
        b = gev[k]
        if a.dtype.is_floating_point:
            iv = torch.int64 if a.dtype == torch.float64 else torch.int32
            a, b = a.view(iv), b.view(iv)
        if not torch.equal(a, b):
            return k
    return None


def kf_check(title, args, want, dev, grp, quals=None):
    """KF against its twin on one chunk (``args`` the frontend's
    arguments, ``quals`` its qualities in substitution mode, ``want`` the
    twin's (ev, n_events) on them): bitwise on every output, no host sync
    (sync debug mode "error"), K3 on KF's rows giving the genes of K3 on
    the twin's; KF's device time (CUDA events), the twin's and the bound.
    Returns KF's case record."""
    import torch

    from glimmer_mg_torch.ops import event_dp_cuda, frontend, frontend_cuda
    from glimmer_mg_torch.ops import device_predict as dpk

    frontend_cuda.frontend(*args, quals=quals)  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = frontend_cuda.frontend(*args, quals=quals)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    (wev, wn), (gev, gn) = want, got
    bad = kf_differs(want, got)
    assert bad is None, f"KF {bad} differs from its twin ({title})"
    consts = args[7]
    tables = {k: dev[k] for k in ("adj_or", "adj_dist", "adj_dist_len")}
    genes = []
    for ev, n in (want, got):
        ne = torch.clamp(n, max=dpk.MAX_EVENTS)
        genes.append(event_dp_cuda.event_dp_traceback(ev, tables, grp,
                                                      consts, ne)[4:])
    for a, b in zip(*genes):
        assert torch.equal(a, b), f"K3's genes on KF's rows differ ({title})"
    diff = (wev["score"] - gev["score"]).abs()
    diff = diff[torch.isfinite(diff)]
    err = float(diff.max()) if diff.numel() else 0.0
    ms = kernel_ms(lambda: frontend_cuda.frontend(*args, quals=quals))
    plain = cuda_ms(lambda: frontend.frontend(*args, quals=quals), reps=3)
    nbytes = kf_bytes(args, gev, quals)
    bound_ms, by = bound(nbytes, 0)
    over = int((gn > dpk.MAX_EVENTS).sum())
    n_sub = 0
    if "err_typ" in gev:
        E = gev["pos"].shape[1]
        live = (torch.arange(E, device=gn.device)[None]
                < gn.clamp(max=E)[:, None])
        n_sub = int(((gev["err_typ"] == 2) & live).sum())
    res = kf_case_resources(args)
    log(f"KF {title}: B {gn.shape[0]} x Lp {args[6]}; every output bitwise "
        f"equal to its twin ({int(gn.sum())} events, {n_sub} with a "
        f"substitution record in the rows, {over} reads past "
        f"{dpk.MAX_EVENTS}), K3's genes on KF's rows equal to those on the "
        f"twin's, KF host syncs 0 (sync debug mode error); KF {ms:.4f} ms "
        f"(device, CUDA events), twin {plain:.4f} ms; bound {bound_ms:.4f} "
        f"ms ({nbytes / 1e6:.3f} MB over 3.35 TB/s); {json.dumps(res)} "
        f"[{gpu_line()}]")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": by, "max_abs_err": err, "n_events": int(gn.sum()),
            "sub_events": n_sub, "reads_past_max_events": over, **res}


def chunk_inputs(gd, reads, cmap, quals=None, subs=False, Lp=768):
    """The first 2,048 reads' chunk as the device route builds it (padded
    to Lp, each read's classes' models, one bank): (bank, its tables on the
    card,
    reads, lengths, groups, the (B, Lp) uint8 qualities or None, the
    frontend's constants with the f64 carry)."""
    import numpy as np
    import torch

    from glimmer_mg_torch.engine import glimmer_mg as tmg
    from glimmer_mg_torch.host import dna
    from glimmer_mg_torch.ops import device_predict as dpk

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
    bank = dpk.build_bank(models, Lp)
    dev = dpk.bank_to_device(bank, DEVICE)
    reads_t = torch.zeros((len(chunk), Lp), dtype=torch.int32)
    for r, (_h, s) in enumerate(chunk):
        reads_t[r, :len(s)] = torch.from_numpy(dna.encode(s).astype("int32"))
    reads_t = reads_t.to(DEVICE)
    lens = torch.tensor([len(s) for _h, s in chunk],
                        dtype=torch.int32).to(DEVICE)
    grp = torch.tensor(group, dtype=torch.int32).to(DEVICE)
    q_t = None
    if quals:
        q = np.full((len(chunk), Lp), 255, np.uint8)
        for r, (h, _s) in enumerate(chunk):
            if h in quals:
                q[r, :len(quals[h])] = np.minimum(quals[h], 254)
        q_t = torch.from_numpy(q).to(DEVICE)
    consts = dict(min_gene_len=bank.min_gene_len, max_olap=bank.max_olap,
                  event_threshold=bank.event_threshold,
                  start_threshold=bank.start_threshold,
                  ws=bank.ribosome_window, W=bank.pwm_w, fdt=torch.float64,
                  subs=subs)
    return bank, dev, reads_t, lens, grp, q_t, consts


def stage_breakdown(gd, reads, cmap, title="stage breakdown", quals=None,
                    subs=False):
    """Host-clock stage times (synchronised; each stage runs once untimed
    first, so that none pays for loading its kernels) of one 2,048-read
    chunk, in substitution mode with ``subs`` (``quals``: qualities by
    header), KF and its twin, K3 and its twin (event DP, then traceback)
    as separate stages; then K3 against its twin on the chunk's rows
    (``k3_check``) and KF against its twin on the chunk (``kf_check``)
    with the f64 and the f32 carry, recorded in K3["cases"] and
    KF["cases"]; in substitution mode with qualities KF is also held to
    its twin on the same chunk without them (the "subs" cases)."""
    import torch

    from glimmer_mg_torch.ops import device_predict as dpk
    from glimmer_mg_torch.ops import event_dp, event_dp_cuda, frontend
    from glimmer_mg_torch.ops import frontend_cuda, icm_cuda

    bank, dev, reads_t, lens, grp, q_t, consts = chunk_inputs(
        gd, reads, cmap, quals, subs)
    tables = {k: dev[k] for k in ("adj_or", "adj_dist", "adj_dist_len")}
    times = {}

    def stage(name, fn):
        fn()  # warm
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
    mode = "subs_quals" if subs and quals else ("subs" if subs
                                                else "error_free")
    rows, kf_in = {}, {}
    for fdt in (torch.float64, torch.float32):
        c = dict(consts, fdt=fdt)
        carry = "" if fdt == torch.float64 else "_f32"
        fargs = (reads_t, lens, grp, g6, i6, dev, 768, c, dpk.MAX_EVENTS)
        ev, n_ev = stage("frontend (twin)" + carry,
                         lambda: frontend.frontend(*fargs, quals=q_t))
        stage("frontend (KF)" + carry,
              lambda: frontend_cuda.frontend(*fargs, quals=q_t))
        kf_in[(mode, fdt)] = (fargs, q_t, (ev, n_ev))
        if q_t is not None:
            kf_in[("subs", fdt)] = (fargs, None, frontend.frontend(*fargs))
        rows[fdt] = (ev, c, torch.clamp(n_ev, max=dpk.MAX_EVENTS))
    ev, _c, ne = rows[torch.float64]
    stage("event_dp_traceback (K3)", lambda: event_dp_cuda.event_dp_traceback(
        ev, tables, grp, consts, ne))
    adj = event_dp._prefetch_adj(dev, grp)
    sc, bp, best, _w = stage("event_dp (twin)", lambda:
                             event_dp.event_dp_batched(ev, adj, consts, ne))
    syncs = event_dp.last_syncs
    stage("traceback (twin)", lambda: event_dp.traceback_batched(
        ev, sc, bp, best, ne))
    log(f"{title}, one {reads_t.shape[0]}-read chunk "
        "(ms, host clock, synchronised): "
        + json.dumps({k: round(v, 3) for k, v in times.items()})
        + f"; DP steps {int(ne.max())}, K3 host syncs 0, the twin's event "
        f"DP {syncs}")
    for fdt, (ev, c, ne) in rows.items():
        carry = "f64" if fdt == torch.float64 else "f32"
        K3["cases"][f"{mode}_{carry}"] = k3_check(
            f"{mode} {carry}", ev, dev, grp, c, ne)
    for (kmode, fdt), (fargs, q, want) in kf_in.items():
        carry = "f64" if fdt == torch.float64 else "f32"
        KF["cases"][f"{kmode}_{carry}"] = kf_check(
            f"{kmode} {carry}", fargs, want, dev, grp, quals=q)


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
    from glimmer_mg_torch.ops import event_dp_cuda, frontend_cuda, icm_cuda
    from glimmer_mg_torch.parallel import phymm
    from glimmer_mg_torch.pipeline import glimmer_mg_pipe as pipe

    fa = os.path.join(root, "reads.fa")
    write_fasta(fa, reads)
    work = os.path.join(root, "pipe")
    timers = pipe.StageTimers()
    tmg.reset_counters()
    icm_cuda.reset_launches()
    event_dp_cuda.reset_launches()
    frontend_cuda.reset_launches()
    t0 = time.perf_counter()
    with raw_matrices() as rt:
        final = pipe.run_pipeline(fa, icm_dir, device=DEVICE, iterate=0,
                                  workdir=work, timers=timers)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    count_raw_text("pipeline", rt)
    k1, k2 = icm_cuda.launches, icm_cuda.bank_walk_launches
    K3["paths"]["pipeline"] = k3 = event_dp_cuda.launches
    KF["paths"]["pipeline"] = kf = frontend_cuda.launches
    counts = dict(tmg.counters)
    log(f"pipeline path (cold): {len(reads)} reads in {cold:.2f} s; "
        f"K2 launches {k2}, K1 launches {k1}, K3 launches {k3}, KF "
        f"launches {kf}; routes {counts}")
    assert kf > 0, "the pipeline did not launch KF"
    log_parts("pipeline (iterate=0, cold)", cold,
              {st.name: st.wall_s for st in timers.stages})
    assert k2 > 0, "the pipeline did not launch K2"
    assert k1 > 0, "the pipeline did not launch K1"
    assert k3 > 0, "the pipeline did not launch K3"

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
        engine="host"))
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
              (icm_cuda, "bank_score_both_strands", "bank_walk", True),
              (phymm, "write_raw_phymm_output", "raw_file", False),
              (phymm, "write_results_table", "results_file", False)]
    with raw_matrices() as rt, wrapped_parts(stages) as parts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths, _rids, _s = phymm.classify_file(fa, icm_dir, out_dir=out,
                                               device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    count_raw_text("classify_warm", rt)
    log(f"warm classify_file: {n_reads} reads x {len(paths)} ICMs, "
        f"{n_reads / wall:.1f} reads/s, "
        f"{2 * bp * len(paths) / 1e6 / wall:.1f} model-Mbp/s (fwd + rc)")
    log_parts("warm classify_file", wall, parts)


def family_taxonomy(icm_dir):
    """Each strain's Phymm ranks (genus, family, order, class, phylum),
    its family the source genome's: g<k> is family f<k>, and decoy k (a
    copy of genome k % 4, add_decoys) family f<k % 4>. Clusters seeded at
    the family rank then hold a genome and its decoys."""
    from glimmer_mg_torch.parallel.phymm import genome_icm_paths, path_to_genome

    tax = {}
    for path in genome_icm_paths(icm_dir):
        strain = path_to_genome(path).split("|")[0]
        k = (int(strain[5:]) % 4 if strain.startswith("decoy")
             else int(strain[1:]))
        tax[strain] = ("", f"f{k}", "", "", "")
    return tax


@contextlib.contextmanager
def em_probes():
    """For the block, record what stages 4-5 run: each bank training's
    and its histograms' device time, each EM bank walk's (K2) time and the
    reads whose best cluster it changed, the first training's arguments and
    its last (level-7) histogram's, the last EM walk's arguments, the K2
    launches inside scimm_cluster and the K1 and K3 launches inside
    repredict (differences of the wrappers' own counts; ``in_repredict``
    is true while repredict runs), and the EM's seeds. Each timed call is
    synchronised before and after."""
    import torch

    from glimmer_mg_torch.ops import event_dp_cuda, frontend_cuda, icm_cuda
    from glimmer_mg_torch.ops import icm_train_device as itd
    from glimmer_mg_torch.pipeline import glimmer_mg_pipe as pipe, scimm

    rec = {"train_ms": [], "hist_ms": [], "k2_ms": [], "moved": [],
           "scimm": 0, "repredict": 0, "repredict_k3": 0, "repredict_kf": 0,
           "in_em": False,
           "in_repredict": False}
    real = {(itd, "train_icm_bank"): itd.train_icm_bank,
            (itd, "level_histogram"): itd.level_histogram,
            (icm_cuda, "bank_score_both_strands"):
                icm_cuda.bank_score_both_strands,
            (scimm, "scimm_cluster"): scimm.scimm_cluster,
            (pipe, "repredict"): pipe.repredict}

    def synced(fn, key, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        rec[key].append((time.perf_counter() - t0) * 1e3)
        return out

    def train(*a, **k):
        rec.setdefault("first_train", (a, k))
        rec["hist_ms"].append(0.0)
        return synced(real[itd, "train_icm_bank"], "train_ms", *a, **k)

    def hist(*a, **k):
        if len(rec["hist_ms"]) == 1:
            rec["hist_args"] = (a, k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real[itd, "level_histogram"](*a, **k)
        torch.cuda.synchronize()
        rec["hist_ms"][-1] += (time.perf_counter() - t0) * 1e3
        return out

    def k2(*a, **k):
        fn = real[icm_cuda, "bank_score_both_strands"]
        if not rec["in_em"]:
            return fn(*a, **k)
        rec["last_k2"] = (a, k)
        out = synced(fn, "k2_ms", *a, **k)
        # reads whose best cluster differs from the assignment scored
        best = out.argmax(dim=1).cpu()
        rec["moved"].append(int((best != rec["assign"]).sum()))
        rec["assign"] = best
        return out

    def cluster(*a, **k):
        n0 = icm_cuda.bank_walk_launches
        rec.update(in_em=True, init=a[1], n_clusters=a[2],
                   assign=torch.as_tensor(a[1]).to(torch.int64))
        try:
            return real[scimm, "scimm_cluster"](*a, **k)
        finally:
            rec["in_em"] = False
            rec["scimm"] += icm_cuda.bank_walk_launches - n0

    def repredict(*a, **k):
        n0, n3 = icm_cuda.launches, event_dp_cuda.launches
        nf = frontend_cuda.launches
        rec["in_repredict"] = True
        try:
            return real[pipe, "repredict"](*a, **k)
        finally:
            rec["in_repredict"] = False
            rec["repredict"] += icm_cuda.launches - n0
            rec["repredict_k3"] += event_dp_cuda.launches - n3
            rec["repredict_kf"] += frontend_cuda.launches - nf

    probes = {(itd, "train_icm_bank"): train,
              (itd, "level_histogram"): hist,
              (icm_cuda, "bank_score_both_strands"): k2,
              (scimm, "scimm_cluster"): cluster,
              (pipe, "repredict"): repredict}
    try:
        for (mod, name), fn in probes.items():
            setattr(mod, name, fn)
        yield rec
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)


def log_em(title, rec):
    """The EM's iterations (one K2 walk each; a converged EM stops after
    the walk that changed no read, one that reaches max_iters trains once
    more) and each iteration's training (its histograms among it) and K2
    milliseconds."""
    iters, trains = len(rec["k2_ms"]), len(rec["train_ms"])
    log(f"{title}: {iters} EM iterations, "
        f"{'converged' if trains == iters else 'stopped at max_iters'}; "
        f"{trains} trainings; per iteration (ms, host clock, synchronised)"
        ": train " + json.dumps([round(x, 3) for x in rec["train_ms"]])
        + ", of which histograms "
        + json.dumps([round(x, 3) for x in rec["hist_ms"]])
        + ", K2 " + json.dumps([round(x, 3) for x in rec["k2_ms"]])
        + "; reads changing cluster " + json.dumps(rec["moved"]))


def index_add_histogram(model, frame, ctx, last, node_local, valid,
                        n_models, periodicity, nodes_on_level, model_len):
    """``icm_train_device.level_histogram`` as 11 ``index_add_`` passes,
    one per window position, invalid positions sent to a sink bin past the
    end: the form it replaced, kept to time against it."""
    import torch

    w = model_len - 1
    size = n_models * periodicity * nodes_on_level * w * 16
    base = ((model * periodicity + frame) * nodes_on_level
            + node_local) * (w * 16)
    counts = torch.zeros(size + 1, dtype=torch.int64, device=ctx.device)
    ones = torch.ones(base.shape, dtype=torch.int64, device=ctx.device)
    for j in range(w):
        pair = 4 * ((ctx >> (2 * j)) & 3) + last
        counts.index_add_(0, torch.where(valid, base + j * 16 + pair, size),
                          ones)
    return counts[:size].reshape(n_models, periodicity, nodes_on_level, w, 16)


def iterate_phase(root, icm_dir, gd, reads, check):
    """Stages 4-5 on the card: the reads, upper case, as a FASTA file
    through run_pipeline(iterate=1) (classify with K2, parse, predict with
    K1, cluster with the device EM: the bank trainer and K2 on the cluster
    bank, repredict each cluster with K1), counted and checked, each kernel
    held to its twin on the inputs of one of its calls on this path.
    Returns (K2 launches in the EM, K1 launches in repredict).

    Upper case because retraining matches codons case-sensitively against
    upper-case codons, as the reference's train_features.py does: with
    lower-case reads it finds no non-gene ORF."""
    import numpy as np
    import torch

    from glimmer_mg_torch.engine import glimmer_mg as tmg
    from glimmer_mg_torch.host import read_fasta, read_icm, write_fasta
    from glimmer_mg_torch.io.genome_data import parse_classes
    from glimmer_mg_torch.models import features as feat
    from glimmer_mg_torch.ops import icm_cuda, icm_score
    from glimmer_mg_torch.ops import icm_train_check as chk
    from glimmer_mg_torch.ops import icm_train_device as itd
    from glimmer_mg_torch.pipeline import elph, glimmer_mg_pipe as pipe, scimm
    from glimmer_mg_torch.pipeline import train_features as tf

    reads = [(h, s.upper()) for h, s in reads]
    os.makedirs(os.path.join(root, "upper"))
    fa = os.path.join(root, "upper", "reads.fa")
    write_fasta(fa, reads)
    taxonomy = family_taxonomy(icm_dir)
    work = os.path.join(root, "pipe_iter")
    timers = pipe.StageTimers()
    with em_probes() as rec, \
            widest_six_frame(lambda: rec["in_repredict"]) as widest, \
            raw_matrices() as rt:
        tmg.reset_counters()
        icm_cuda.reset_launches()
        t0 = time.perf_counter()
        final = pipe.run_pipeline(fa, icm_dir, device=DEVICE, iterate=1,
                                  taxonomy=taxonomy, workdir=work,
                                  timers=timers)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        k1, k2 = icm_cuda.launches, icm_cuda.bank_walk_launches
    count_raw_text("iterate", rt)
    n_clusters = rec["n_clusters"]
    log(f"iterate path (cold): {len(reads)} reads in {cold:.2f} s; "
        f"init_clusters_from_results made {n_clusters} clusters (family "
        f"rank); K2 launches {k2} ({rec['scimm']} in the EM), K1 launches "
        f"{k1} ({rec['repredict']} in repredict), K3 launches in repredict "
        f"{rec['repredict_k3']}, KF launches in repredict "
        f"{rec['repredict_kf']}; routes {dict(tmg.counters)}")
    K3["paths"]["repredict"] = rec["repredict_k3"]
    KF["paths"]["repredict"] = rec["repredict_kf"]
    assert rec["repredict_k3"] > 0, "repredict did not launch K3"
    assert rec["repredict_kf"] > 0, "repredict did not launch KF"
    log_parts("iterate pipeline (cold)", cold,
              {st.name: st.wall_s for st in timers.stages})
    log_em("device EM (cold run)", rec)
    a, kw = rec["first_train"]
    depth = kw["depth"]
    log(f"level-{depth} histogram: {8 * n_clusters * 3 * 4 ** depth * 11 * 16}"
        f" bytes (int64, {n_clusters} models x 3 frames x {4 ** depth} "
        f"nodes x 11 window positions x 16 pairs)")
    assert [st.name for st in timers.stages] == [
        "phymm", "parse_phymm", "iter0", "cluster", "repredict"]
    assert rec["scimm"] > 0, "the EM did not launch K2"
    assert rec["repredict"] > 0, "repredict did not launch K1"
    assert rec["scimm"] == len(rec["k2_ms"]) >= 1
    assert n_clusters >= 2, n_clusters
    check_widest("repredict", widest)

    # the first EM training on the card against the same code on the CPU
    rec_g, rec_c = {}, {}
    t0 = time.perf_counter()
    trained_g = itd.train_icm_bank(*a, **kw, record=rec_g)
    torch.cuda.synchronize()
    t_g = time.perf_counter() - t0
    t0 = time.perf_counter()
    trained_c = itd.train_icm_bank(*(x.cpu() for x in a), **kw,
                                   record=rec_c)
    t_c = time.perf_counter() - t0
    ties, worst = chk.tie_nodes(*trained_c, rec_c, *trained_g, rec_g)
    log(f"EM training on the card vs the CPU ({a[0].shape[0]} reads x "
        f"{a[0].shape[1]} bases, {n_clusters} models, depth "
        f"{kw['depth']}; {t_g:.3f} s vs {t_c:.3f} s): counts equal, mutual "
        f"information within {worst:.3f} x 2^-23 x its terms' magnitude "
        f"(bound {chk.MI_REL / chk.F32_EPS:g}), mip equal at every compared "
        f"node but {len(ties)} near-ties, logged probs within 4 ulps")
    for t in ties:
        log(f"  near-tie (CPU, card): {json.dumps(t)}")

    # the level histogram against the 11 index_add_ passes it replaced,
    # on the first training's level-7 inputs
    ha, hk = rec["hist_args"]
    same = torch.equal(itd.level_histogram(*ha, **hk),
                       index_add_histogram(*ha, **hk))
    log(f"level-{depth} histogram, {int(ha[5].sum())} counted of "
        f"{ha[5].numel()} positions (ms, CUDA events, median of 5): one "
        f"bincount over masked keys "
        f"{cuda_ms(lambda: itd.level_histogram(*ha, **hk)):.3f}, 11 "
        f"index_add_ passes with a sink bin "
        f"{cuda_ms(lambda: index_add_histogram(*ha, **hk)):.3f}; counts "
        f"{'equal' if same else 'DIFFER'}")
    assert same, "the two level histograms differ"

    # K2 inside the EM, the last iteration's call (its packed cluster
    # tables, all of its reads), against its twin
    (lm, pk, r, ln, *rest), kw = rec["last_k2"]
    got = icm_cuda.bank_score_both_strands(lm, pk, r, ln, *rest, **kw)
    shape = dict(zip(("model_len", "depth"), rest), **kw)
    rc = icm_score.revcomp_reads(r, ln)
    want = torch.maximum(*(icm_score.bank_score_reads_packed(
        lm, pk, x, ln, **shape) for x in (r, rc)))
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    log(f"K2 in the EM vs twin (last iteration's call: {lm.shape[0]} "
        f"cluster tables, all {r.shape[0]} reads x {r.shape[1]} bases): "
        f"{'bitwise equal' if same else 'DIFFER'}")
    assert same, "K2 in the EM differs from its twin"

    with open(final) as fh:
        headers = [line[1:].rstrip("\n") for line in fh
                   if line.startswith(">")]
    assert sorted(headers) == sorted(h for h, _s in reads), \
        "the final .predict does not hold every read once"

    # the largest cluster's reprediction against the host engine, with the
    # cluster's own models (its GC is the whole cluster's, so every read
    # goes in; only the first ``check`` are predicted by the host engine)
    sizes = {k: sum(1 for _ in read_fasta(os.path.join(
        work, f"cluster-{k}.fa"))) for k in range(n_clusters)}
    big = max(sizes, key=sizes.get)
    c_reads = list(read_fasta(os.path.join(work, f"cluster-{big}.fa")))
    prefix = os.path.join(work, f"reads.cluster-{big}")
    rbs = feat.PWM.read(f"{prefix}.run1.motif")
    rbs.counts_to_prob()
    rbs.probs_to_logs()
    real_host = tmg._host_predict
    budget = [check]

    def first_reads_only(jobs, *a, **k):
        n = min(budget[0], len(jobs))
        budget[0] -= n
        return real_host(jobs[:n], *a, **k) + [[] for _ in jobs[n:]]

    tmg._host_predict = first_reads_only
    try:
        host = list(tmg.run_glimmer_mg_classes(
            c_reads, gd, parse_classes(os.path.join(work, "reads.class.txt")),
            device=DEVICE, user_icm=read_icm(f"{prefix}.run1.gicm"),
            user_rbs_pwm=rbs, features_path=f"{prefix}.run1.features.txt",
            engine="host"))[:check]
    finally:
        tmg._host_predict = real_host
    with open(f"{prefix}.predict") as fh:
        blocks = predict_blocks(fh.read())
    same = "".join(blocks[h] for h, _g in host) == tmg.format_predict_mg(host)
    log(f"cluster {big} ({sizes[big]} of {len(reads)} reads; sizes "
        f"{json.dumps(sizes)}): first {len(host)} reads of its .predict vs "
        f"host engine with its run1.gicm, .motif and .features.txt: "
        f"{'byte-identical' if same else 'DIFFER'} "
        f"({sum(len(g) for _h, g in host)} genes)")
    assert same, "the cluster's reprediction differs from the host engine"

    # the host EM against the device EM on the first 1,024 reads, for the
    # record (the device EM scores through K2's 16-bit tables)
    seqs = [s for _h, s in reads[:1024]]
    init = np.asarray(rec["init"])[:1024]
    t0 = time.perf_counter()
    a_dev, _i, _s = scimm.scimm_cluster(seqs, init, n_clusters,
                                        device=DEVICE)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    a_host, _i, _s = scimm.scimm_cluster(seqs, init, n_clusters,
                                         use_device=False, device=DEVICE)
    t_host = time.perf_counter() - t0
    log(f"host EM vs device EM on the first {len(seqs)} reads: assignments "
        f"agree for {float(np.mean(a_dev == a_host)):.4f} (device EM "
        f"{t_dev:.2f} s, host EM {t_host:.2f} s; not a gate)")

    # a warm run without the probes (no synchronisation but at its end)
    timers = pipe.StageTimers()
    parts = [(tf, "train_features", "train_features", False),
             (elph, "motif_counts", "motif_finder", False)]
    with raw_matrices() as rt, wrapped_parts(parts) as repredict_parts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.run_pipeline(fa, icm_dir, device=DEVICE, iterate=1,
                          taxonomy=taxonomy,
                          workdir=os.path.join(root, "pipe_iter_warm"),
                          timers=timers)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    count_raw_text("iterate", rt)
    stages = {st.name: st.wall_s for st in timers.stages}
    log_parts("warm pipeline (iterate=1, unprobed)", wall, dict(stages))
    retrain = repredict_parts.get("train_features", 0.0)
    log(f"warm repredict stage {stages['repredict']:.4f} s: retraining "
        f"(train_features, host Python) {retrain:.4f} s, of which the RBS "
        f"motif finder {repredict_parts.get('motif_finder', 0.0):.4f} s; "
        f"the rest (the clusters' predictions with their retrained models, "
        f"files) {stages['repredict'] - retrain:.4f} s")
    return rec["scimm"], rec["repredict"]


def with_substitutions(reads, rate, seed):
    """Each base replaced by another at ``rate``; Phred 2-41 qualities for
    two reads in three. Returns (reads, qualities by header)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out, quals = [], {}
    for i, (h, s) in enumerate(reads):
        seq = np.frombuffer(s.encode(), dtype=np.uint8).copy()
        hit = rng.random(len(seq)) < rate
        shift = rng.integers(1, 4, len(seq))
        idx = np.searchsorted(np.frombuffer(b"acgt", np.uint8), seq)
        seq[hit] = np.frombuffer(b"acgt", np.uint8)[(idx + shift)[hit] % 4]
        out.append((h, seq.tobytes().decode()))
        if i % 3 != 2:
            quals[h] = rng.integers(2, 42, len(seq)).tolist()
    return out, quals


def with_homopolymer_indels(reads, rate, seed):
    """454-like errors: inside homopolymer runs (about a quarter of the
    bases) a base is dropped or repeated at 4 x ``rate``, so ``rate`` per
    base over a read."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for h, s in reads:
        u = rng.random(len(s))
        parts = []
        for k, ch in enumerate(s):
            r = u[k] if k and s[k - 1] == ch else 1.0
            if r >= 2 * rate:
                parts.append(ch + ch if r < 4 * rate else ch)
        out.append((h, "".join(parts)))
    return out


@contextlib.contextmanager
def widest_six_frame(active=lambda: True):
    """For the block, keep the K1 call (``icm_cuda.mg_six_frame``) with
    the most bank rows among those made while ``active()``: its arguments
    and a copy of its outputs. The capture launches nothing itself."""
    from glimmer_mg_torch.ops import icm_cuda

    widest = {}
    real = icm_cuda.mg_six_frame

    def capture(*a, **k):
        res = real(*a, **k)
        if active() and a[0].shape[0] > widest.get("G", 0):
            widest.update(G=a[0].shape[0], args=a, kw=k,
                          out=[x.clone() for x in res])
        return res

    icm_cuda.mg_six_frame = capture
    try:
        yield widest
    finally:
        icm_cuda.mg_six_frame = real


def check_widest(name, widest):
    """Hold a captured K1 call (``widest_six_frame``) bitwise to its twin
    on the same inputs."""
    assert widest, f"no K1 call was captured on the {name} route"
    bitwise, (B, L, G) = k1_check(widest)
    log(f"{name}: K1 vs twin on the route's own inputs (its call with the "
        f"most bank rows): B={B} L={L} G={G} "
        f"depth={widest['kw']['depth']}: "
        f"{'bitwise equal' if bitwise else 'DIFFER'}")
    assert bitwise, f"K1 differs from its twin on the {name} route"


def k1_check(widest):
    """A captured K1 call (``widest_six_frame``) against its twin on the
    same inputs: (bitwise equal, [B, L, G])."""
    import torch

    from glimmer_mg_torch.ops import icm_score

    assert widest, "no K1 call was captured"
    args, kw = widest["args"], dict(widest["kw"])
    kw.pop("folded", None)
    kw.pop("ranges_checked", None)
    tg, ti = icm_score.mg_six_frame_batch(*args, **kw)
    kg, ki = widest["out"]
    same = (torch.equal(kg.view(torch.int32), tg.view(torch.int32))
            and torch.equal(ki.view(torch.int32), ti.view(torch.int32)))
    return same, [*map(int, args[4].shape), int(widest["G"])]


def error_mode_phase(name, gd, reads, cmap, check, **kw):
    """One error mode's path (run_glimmer_mg_classes options ``kw``):
    a counted cold pass, K1 against its twin on the inputs of the pass's
    call with the most bank rows, a warm pass for reads/s, a timed pass
    split by layer, and the first ``check`` reads against the host engine.
    Returns (K1 launches of the counted pass, route counters, genes, the
    cold pass's output, the host engine's output on the first reads)."""
    import torch

    from glimmer_mg_torch.engine import glimmer_mg as tmg
    from glimmer_mg_torch.ops import event_dp_cuda, frontend_cuda, icm_cuda

    tmg.reset_counters()
    icm_cuda.reset_launches()
    event_dp_cuda.reset_launches()
    frontend_cuda.reset_launches()
    with widest_six_frame() as widest:
        t0 = time.perf_counter()
        out = list(tmg.run_glimmer_mg_classes(reads, gd, cmap, device=DEVICE,
                                              **kw))
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
    launches, counts = icm_cuda.launches, dict(tmg.counters)
    K3["paths"][name.split()[0]] = event_dp_cuda.launches
    # substitution mode runs KF on the device route; indel mode runs the
    # native engine on K1's scores and launches no KF
    if kw.get("allow_subs"):
        KF["paths"][name.split()[0]] = frontend_cuda.launches
        assert frontend_cuda.launches > 0, f"the {name} path did not " \
                                           "launch KF"
    else:
        assert frontend_cuda.launches == 0, frontend_cuda.launches
    genes = [g for _h, gs in out for g in gs]
    log(f"{name} pass 1: {len(out)} reads in {cold:.2f} s; K1 launches "
        f"{launches}, K3 launches {event_dp_cuda.launches}, KF launches "
        f"{frontend_cuda.launches}; routes "
        f"{counts}; {len(genes)} genes, "
        f"{sum(1 for g in genes if g.errors)} with error records")
    assert launches > 0, f"the {name} path did not launch K1"
    assert len(out) == len(reads)
    check_widest(name, widest)
    for g in genes:
        assert g.score == g.score and abs(g.score) < 1e6
        assert g.frame in (-3, -2, -1, 1, 2, 3)

    t0 = time.perf_counter()
    out2 = list(tmg.run_glimmer_mg_classes(reads, gd, cmap, device=DEVICE,
                                           **kw))
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    assert tmg.format_predict_mg(out2) == tmg.format_predict_mg(out)
    log(f"{name} pass 2 (warm): {len(reads)} reads in {warm:.3f} s = "
        f"{len(reads) / warm:.1f} reads/s")
    timed_pass(gd, reads, cmap, out, title=f"{name} timed warm pass", **kw)

    sub = reads[:check]
    host = list(tmg.run_glimmer_mg_classes(
        sub, gd, {h: cmap[h] for h, _s in sub}, device=DEVICE,
        engine="host", **kw))
    by_header = dict(out)
    mine = [(h, by_header[h]) for h, _g in host]
    same = tmg.format_predict_mg(host) == tmg.format_predict_mg(mine)
    log(f"{name}: first {len(sub)} reads vs host engine: "
        f"{'byte-identical' if same else 'DIFFER'} "
        f"({sum(len(g) for _h, g in host)} genes, "
        f"{sum(1 for _h, gs in host for g in gs if g.errors)} with error "
        f"records)")
    assert same, f"{name} output differs from the host engine"
    return launches, counts, genes, out, host


def subs_phase(gd, genomes, n_reads, check, seed):
    """Phase 7: substitution mode on the card. Returns (K1's launches,
    the case for phase 9: reads, classes, options, output, the host
    engine's output on the first reads)."""
    reads, cmap = sample_reads(genomes, n_reads, seed)
    reads, quals = with_substitutions(reads, 0.005, seed + 1)
    launches, counts, genes, out, host = error_mode_phase(
        "subs mode", gd, reads, cmap, check, allow_subs=True,
        qualities=quals)
    assert K3["paths"]["subs"] > 0, "the subs mode path did not launch K3"
    stage_breakdown(gd, reads, cmap, "subs mode stage breakdown",
                    quals=quals, subs=True)
    assert counts["device_reads"] + counts["host_reads"] == len(reads)
    assert counts["host_reads"] == counts["overflow_reads"], counts
    assert counts["host_reads"] <= 0.05 * len(reads), counts
    n_sub = sum(1 for g in genes if g.errors)
    assert all(e.type == 2 for g in genes for e in g.errors)
    assert n_sub >= 0.01 * len(genes), (n_sub, len(genes))
    return launches, {"reads": reads, "cmap": cmap, "out": out, "host": host,
                      "kw": {"allow_subs": True, "qualities": quals}}


def indel_phase(gd, genomes, n_reads, check, seed):
    """Phase 8: indel mode, K1 on the card feeding the native engine.
    Returns K1's launches."""
    from glimmer_mg_torch import native

    reads, cmap = sample_reads(genomes, n_reads, seed)
    reads = with_homopolymer_indels(reads, 0.003, seed + 1)
    log(f"indel mode: native engine threads {native.default_threads()} "
        f"(host cores {os.cpu_count()})")
    launches, counts, _genes, _out, _host = error_mode_phase(
        "indel mode", gd, reads, cmap, check, allow_indels=True)
    assert counts["native_reads"] == len(reads), counts
    assert counts["host_reads"] == counts["device_reads"] == 0, counts
    return launches


def copy_ms(n_values):
    """Median ms (CUDA events) of copying ``n_values`` f64 from the card
    into pinned host memory (non-blocking, as the native route does) and
    into pageable memory."""
    import torch

    src = torch.rand(n_values, dtype=torch.float64, device=DEVICE)
    pinned = torch.empty(n_values, dtype=torch.float64, pin_memory=True)
    return (cuda_ms(lambda: pinned.copy_(src, non_blocking=True), reps=11),
            cuda_ms(lambda: src.cpu(), reps=11))


def routes_phase(gd, cases, check):
    """Phase 9: each case's reads (the error-free reads of phase 5, the
    substitution reads of phase 7) on engine="native" with both
    precomputes. Checks: K1 launched on the counted pass (precompute
    "device"), every read counted in native_reads, K1 bitwise equal to
    its twin on the route's call with the most bank rows, every .predict
    byte-identical to the device route's output of the same reads and the
    first ``check`` to the host engine's. Prints warm reads/s of each
    route (native with each precompute, the device route with the overlap
    on and off, native with it off), a timed native pass split by layer,
    and the f64 score copy's ms for a 2,048-read chunk. Returns K1's
    launches on the counted passes."""
    import torch

    from glimmer_mg_torch.engine import glimmer_mg as tmg
    from glimmer_mg_torch.ops import frontend_cuda, icm_cuda

    launches = 0
    for name, case in cases.items():
        reads, cmap, kw = case["reads"], case["cmap"], case["kw"]
        want = tmg.format_predict_mg(case["out"])
        tmg.reset_counters()
        icm_cuda.reset_launches()
        with widest_six_frame() as widest:
            t0 = time.perf_counter()
            got = list(tmg.run_glimmer_mg_classes(
                reads, gd, cmap, device=DEVICE, engine="native", **kw))
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
        n1, counts = icm_cuda.launches, dict(tmg.counters)
        launches += n1
        log(f"{name}, native route (precompute device) pass 1: {len(got)} "
            f"reads in {cold:.2f} s; K1 launches {n1}; routes {counts}")
        assert n1 > 0, f"the native route did not launch K1 ({name})"
        assert counts["native_reads"] == len(reads), counts
        assert counts["host_reads"] == counts["device_reads"] == 0, counts
        check_widest(f"{name}, native route", widest)
        same = tmg.format_predict_mg(got) == want
        by_header = dict(got)
        mine = [(h, by_header[h]) for h, _g in case["host"]]
        same_host = (tmg.format_predict_mg(mine)
                     == tmg.format_predict_mg(case["host"]))
        log(f"{name}, native route: all {len(reads)} reads vs the device "
            f"route: {'byte-identical' if same else 'DIFFER'}; first "
            f"{len(mine)} vs the host engine: "
            f"{'byte-identical' if same_host else 'DIFFER'}")
        assert same, "the native route differs from the device route"
        assert same_host, "the native route differs from the host engine"

        rates, kf = {}, 0
        for label, route, ov in (
                ("native, precompute device", {"engine": "native"}, None),
                ("native, precompute host",
                 {"engine": "native", "precompute": "host"}, None),
                ("native, precompute device, overlap off",
                 {"engine": "native"}, "0"),
                ("device, overlap on", {}, "1"),
                ("device, overlap off", {}, "0")):
            tmg.reset_counters()
            frontend_cuda.reset_launches()
            with overlap(ov):
                t0 = time.perf_counter()
                res = list(tmg.run_glimmer_mg_classes(
                    reads, gd, cmap, device=DEVICE, **route, **kw))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            assert tmg.format_predict_mg(res) == want, label
            if route:
                assert tmg.counters["native_reads"] == len(reads), label
            else:
                kf += frontend_cuda.launches
            rates[label] = round(len(reads) / wall, 1)
        # the device route's passes of this case launch KF in each mode
        KF["paths"]["routes_" + name.split()[0].replace("-", "_")] = kf
        assert kf > 0, f"the device route did not launch KF ({name})"
        log(f"{name}: warm reads/s by route (overlap by default "
            f"{'on' if tmg._overlap_engine() else 'off'} with "
            f"{os.cpu_count()} host cores): {json.dumps(rates)}")
        wall, parts = timed_pass(gd, reads, cmap, case["out"],
                                 title=f"{name}, native route timed warm "
                                       "pass (overlap off)",
                                 engine="native", **kw)
        log(f"{name}, native route: K1 {parts.get('six_frame', 0.0):.4f} s "
            f"= {parts.get('six_frame', 0.0) / wall:.4f} of the pass")
    lens = [len(s) for _h, s in cases["error-free"]["reads"][:2048]]
    pinned, pageable = copy_ms(6 * sum(lens))
    log(f"f64 score copy of a 2,048-read chunk ({6 * sum(lens) * 8 / 1e6:.1f}"
        f" MB, the reads' own positions only): pinned, non-blocking "
        f"{pinned:.4f} ms, pageable {pageable:.4f} ms (medians, CUDA events)")
    return launches


# python -c code: the port's CLI, then the raw-text kernel's launches in
# its process on standard error
CLI_COUNTING_RAW_TEXT = (
    "import sys\n"
    "from glimmer_mg_torch import cli\n"
    "from glimmer_mg_torch.ops import raw_text_cuda\n"
    "rc = cli.main(sys.argv[1:])\n"
    "print('raw_text_launches', raw_text_cuda.launches, file=sys.stderr)\n"
    "sys.exit(rc)\n")


def cli_phase(root, icm_dir, reads, cmap, out, fa):
    """Phase 10: the port's command line, ``python -m glimmer_mg_torch.cli``
    in subprocesses on the card: ``glimmer-mg -c`` on phase 5's reads and
    classes byte-identical to the API's output, ``classify`` with a raw
    matrix byte-identical to phase 6's and classes (parsed as the
    pipeline parses them) equal to phase 6's ``.class.txt``, and
    ``glimmer-mg-pipeline --iterate 0 --raw --cls`` resumed from a copy of
    phase 6's work directory with its ``.predict``. Prints each call's
    wall time, the first beside the API's warm pass."""
    import shutil

    from glimmer_mg_torch.engine import glimmer_mg as tmg
    from glimmer_mg_torch.parallel import phymm
    from glimmer_mg_torch.pipeline import glimmer_mg_pipe as pipe

    here = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(root, "cli")
    os.makedirs(os.path.join(d, "cls"))
    work = os.path.join(root, "pipe")

    def run(*argv, counted=False):
        # counted: the CLI's main, then the raw-text kernel's launches in
        # that process as the last line of its standard error
        cli = (["-c", CLI_COUNTING_RAW_TEXT] if counted
               else ["-m", "glimmer_mg_torch.cli"])
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, *cli, *argv, "--device", DEVICE], cwd=here,
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        assert proc.returncode == 0, (argv[0], proc.stderr[-3000:])
        log(f"CLI {argv[0]}: {wall:.2f} s (a new process: imports, the "
            "kernel library's load, cold caches)")
        if counted:
            return int(proc.stderr.strip().splitlines()[-1].split()[-1])
        return proc.stdout

    classes = os.path.join(d, "classes.txt")
    with open(classes, "w") as fh:
        for h, _s in reads:
            fh.write(f"{h}\t{' '.join(cmap[h])}\n")
    run("glimmer-mg", fa, os.path.join(d, "mg"), "-c", classes,
        "--genome_data", icm_dir)
    with open(os.path.join(d, "mg.predict")) as fh:
        same = fh.read() == tmg.format_predict_mg(out)
    log(f"CLI glimmer-mg -c on {len(reads)} reads vs the API's output: "
        f"{'byte-identical' if same else 'DIFFER'}")
    assert same, "the CLI's glimmer-mg output differs from the API's"

    launched = run("classify", fa, icm_dir, "-o", os.path.join(d, "cls"),
                   counted=True)
    count_raw_text("cli", {"written": 1, "launches": launched})
    raw = phymm.raw_phymm_name(fa)
    with open(os.path.join(d, "cls", raw), "rb") as a, \
            open(os.path.join(work, raw), "rb") as b:
        same_raw = a.read() == b.read()
    got, _top = pipe.parse_phymm(os.path.join(d, "cls", raw),
                                 pipe.informative_genomes(icm_dir), 3)
    text = "".join(f"{rid}\t{' '.join(c)}\n" for rid, c in got.items())
    with open(os.path.join(work, "reads.class.txt")) as fh:
        same_cls = text == fh.read()
    log(f"CLI classify: raw matrix vs phase 6's "
        f"{'byte-identical' if same_raw else 'DIFFER'}; classes vs its "
        f".class.txt {'equal' if same_cls else 'DIFFER'}")
    assert same_raw and same_cls, "the CLI's classify differs from phase 6"

    resumed = os.path.join(d, "pipe")
    shutil.copytree(work, resumed)
    final = run("glimmer-mg-pipeline", fa, icm_dir, "--iterate", "0",
                "--raw", "--cls", "--workdir", resumed).strip()
    with open(final, "rb") as a, \
            open(os.path.join(work, "reads.predict"), "rb") as b:
        same = a.read() == b.read()
    log(f"CLI glimmer-mg-pipeline --iterate 0 --raw --cls resumed from "
        f"phase 6: .predict {'byte-identical' if same else 'DIFFER'}")
    assert same, "the CLI's pipeline output differs from phase 6"


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


MESH_RANKS = 2
MESH_TIMEOUT = 300  # seconds phase 11's ranks may take


@contextlib.contextmanager
def launcher_env(world, rank, port):
    """For the block, the environment a launcher gives rank ``rank`` of a
    world of ``world`` ranks on this machine."""
    keys = {"RANK": str(rank), "LOCAL_RANK": str(rank),
            "WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(keys)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def last_k2():
    """For the block, keep the last two-strand K2 call's arguments and a
    copy of its output. The capture launches nothing itself."""
    from glimmer_mg_torch.ops import icm_cuda

    last = {}
    real = icm_cuda.bank_score_both_strands

    def capture(*a, **k):
        res = real(*a, **k)
        last.update(args=a, kw=k, out=res.clone())
        return res

    icm_cuda.bank_score_both_strands = capture
    try:
        yield last
    finally:
        icm_cuda.bank_score_both_strands = real


def k2_check(last):
    """A captured K2 call against its twin on the same inputs: (bitwise
    equal, (B, M), the kernel's median ms over 5 launches, CUDA events)."""
    import torch

    from glimmer_mg_torch.ops import icm_cuda, icm_score

    assert last, "no K2 call was captured"
    (lm, pk, r, ln, *rest), kw = last["args"], last["kw"]
    shape = dict(zip(("model_len", "depth"), rest), **kw)
    rc = icm_score.revcomp_reads(r, ln)
    want = torch.maximum(*(icm_score.bank_score_reads_packed(
        lm, pk, x, ln, **shape) for x in (r, rc)))
    torch.cuda.synchronize()
    same = torch.equal(last["out"].view(torch.int32), want.view(torch.int32))
    ms = cuda_ms(lambda: icm_cuda.bank_score_both_strands(*last["args"],
                                                          **kw))
    return same, [int(r.shape[0]), int(lm.shape[0])], ms


def host_ms(fn, reps=5):
    """Median host-clock milliseconds of fn() (which synchronises)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def dir_files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, n))}


def cluster_files(d):
    return {n: b for n, b in dir_files(d).items()
            if n.startswith(("cluster-", "icm-"))
            and n.endswith((".fa", ".icm", ".scores.tmp"))}


def mesh_rank(work):
    """One of phase 11's ranks on the card, started by mesh_phase under a
    launcher's environment, every rank on cuda:0 with gloo named as the
    backend (NCCL puts no two ranks on one card). Runs classify_file on
    1x2 and 2x1 meshes, the device EM on 2x1 and data-sharded prediction
    of phase 5's reads on 2x1, each counted from zero and timed, each
    kernel held to its twin on this rank's own last (K2) or widest (K1)
    shard; writes what it saw to <work>/rank<r>.json (rank 0 also the
    files)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from glimmer_mg_torch.engine import glimmer_mg as tmg
    from glimmer_mg_torch.host import GenomeData, read_fasta
    from glimmer_mg_torch.ops import device_predict as dpk
    from glimmer_mg_torch.ops import event_dp_cuda, frontend_cuda, icm_cuda
    from glimmer_mg_torch.parallel import mesh as pmesh, phymm
    from glimmer_mg_torch.parallel.predict import predict_batch_sharded
    from glimmer_mg_torch.pipeline import scimm

    with open(os.path.join(work, "spec.json")) as fh:
        spec = json.load(fh)
    assert pmesh.init_distributed(device=spec["device"], backend="gloo")
    rank = dist.get_rank()
    dev = pmesh.rank_device(spec["device"])
    res = {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
           "wall_s": {}, "launches": {}, "k2": {}}
    try:
        for data, model in ((1, 2), (2, 1)):
            tag = f"classify_file {data}x{model}"
            mesh = pmesh.make_mesh(data, model, device=dev)
            out = os.path.join(work, f"cf_{data}x{model}")
            os.makedirs(out, exist_ok=True)
            icm_cuda.reset_launches()
            with last_k2() as k2, raw_matrices() as rt:
                pmesh.barrier()
                t0 = time.perf_counter()
                phymm.classify_file(spec["fa"], spec["icm_dir"], out_dir=out,
                                    device=dev, mesh=mesh)
                torch.cuda.synchronize()
                res["wall_s"][tag] = time.perf_counter() - t0
            res["launches"][tag] = {"K2": icm_cuda.bank_walk_launches,
                                    "raw_text": rt}
            same, shape, ms = k2_check(k2)
            # the ranks' shares differ, so time a 512-read block's gather
            block = torch.zeros((512, k2["out"].shape[1]), device=dev)

            def gather():
                pmesh.materialize(mesh, block)
                torch.cuda.synchronize()

            res["k2"][tag] = {"bitwise": same, "shape": shape, "ms": ms,
                              "gather_ms": host_ms(gather)}

        tag = "EM 2x1"
        mesh = pmesh.make_mesh(2, 1, device=dev)
        upper = list(read_fasta(spec["fa_upper"]))
        icm_cuda.reset_launches()
        with last_k2() as k2:
            pmesh.barrier()
            t0 = time.perf_counter()
            assign, icms, cscores = scimm.scimm_cluster(
                [s for _h, s in upper], np.array(spec["init"], np.int32),
                spec["n_clusters"], device=dev, mesh=mesh)
            torch.cuda.synchronize()
            res["wall_s"][tag] = time.perf_counter() - t0
        res["launches"][tag] = {"K2": icm_cuda.bank_walk_launches}
        out = os.path.join(work, f"em_2x1_rank{rank}")
        os.makedirs(out)
        if pmesh.is_output_process():
            scimm.write_cluster_artifacts(out, upper, assign, icms, cscores)
        same, shape, ms = k2_check(k2)
        hist = torch.zeros(spec["hist_numel"], dtype=torch.int64, device=dev)

        def all_reduce():
            pmesh.all_reduce_sum(hist, mesh.get_group("data"))
            torch.cuda.synchronize()

        res["k2"][tag] = {"bitwise": same, "shape": shape, "ms": ms,
                          "all_reduce_ms": host_ms(all_reduce, 3)}

        # data-sharded prediction: the engine's chunks of phase 5's reads
        # (captured from its router), each through K1 and the event DP on
        # this rank's shard, the records gathered
        gd = GenomeData(spec["icm_dir"])
        reads = [tuple(r) for r in spec["reads"]]
        chunks = []
        real = tmg._device_dp_chunk
        tmg._device_dp_chunk = lambda jobs, *a, **k: (
            chunks.append(jobs) or [[] for _ in jobs])
        try:
            order = [h for h, _g in tmg.run_glimmer_mg_classes(
                reads, gd, spec["cmap"], device=dev)]
        finally:
            tmg._device_dp_chunk = real
        assert sum(len(j) for j in chunks) == len(order) == len(reads)
        tag = "predict 2x1"
        batches, cache = [], collections.OrderedDict()
        for jobs in chunks:
            rows, models, *batch = tmg._chunk_batch(jobs, tmg._model_tag,
                                                    dev)
            bank = tmg._bank_for(rows, models, batch[0].shape[1], dev, cache)
            batches.append((jobs, bank, [t.cpu().numpy() for t in batch]))
        icm_cuda.reset_launches()
        event_dp_cuda.reset_launches()
        frontend_cuda.reset_launches()
        sharded = []
        with widest_six_frame() as widest:
            pmesh.barrier()
            t0 = time.perf_counter()
            for jobs, (bank, dev_bank), batch in batches:
                sharded.append(predict_batch_sharded(mesh, bank, dev_bank,
                                                     *batch))
            torch.cuda.synchronize()
            res["wall_s"][tag] = time.perf_counter() - t0
        res["launches"][tag] = {"K1": icm_cuda.launches,
                                "K3": event_dp_cuda.launches,
                                "KF": frontend_cuda.launches}
        same, shape = k1_check(widest)
        res["k1"] = {"bitwise": same, "shape": shape}
        if pmesh.is_output_process():
            # the unsharded batches on this rank, and the device-served
            # reads' records as phase 5's .predict prints them
            equal, served, n_over, lo = True, [], 0, 0
            for outs, (jobs, (bank, dev_bank), batch) in zip(sharded,
                                                             batches):
                t = [torch.from_numpy(a).to(dev) for a in batch]
                g6, i6 = icm_cuda.mg_six_frame(
                    dev_bank["gene_mip"], dev_bank["gene_probs"],
                    dev_bank["indep_mip"], dev_bank["indep_probs"], *t,
                    model_len=bank.model_len, depth=bank.depth,
                    gene_periodicity=bank.periodicity)
                plain = dpk.predict_batch_device(bank, dev_bank, *t, g6, i6)
                equal &= all(np.array_equal(a, b)
                             for a, b in zip(outs, plain))
                genes, overflow = dpk.finish_genes(outs, len(jobs))
                n_over += int(overflow[:len(jobs)].sum())
                served += [(order[lo + r], g) for r, g in enumerate(genes)
                           if not overflow[r]]
                lo += len(jobs)
            res["predict"] = {"equal_to_unsharded": equal,
                              "overflow_reads": n_over,
                              "served": len(served)}
            with open(os.path.join(work, "predict_sharded.txt"), "w") as fh:
                fh.write(tmg.format_predict_mg(served))
        with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
    finally:
        pmesh.destroy()


def mesh_phase(root, icm_dir, reads, cmap, out5, overflow5):
    """Phase 11: the (data, model) mesh. A world of 1 rank on NCCL in this
    process runs classify_file, scimm_cluster and run_pipeline(iterate=1)
    at the full width of phases 6 and 6b; then 2 ranks on the card, gloo
    named as their backend, run classify_file on 1x2 and 2x1, the device
    EM on 2x1 and data-sharded prediction of phase 5's reads
    (``mesh_rank``). Every file is held byte for byte to the phase that
    made it, every kernel to its twin on a rank's own shard. Returns the
    (K1, K2) launches of the phase's paths, every rank's summed."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from glimmer_mg_torch.engine import glimmer_mg as tmg
    from glimmer_mg_torch.host import read_fasta
    from glimmer_mg_torch.ops import icm_cuda
    from glimmer_mg_torch.parallel import mesh as pmesh, phymm
    from glimmer_mg_torch.parallel.launch import free_port, run_local
    from glimmer_mg_torch.pipeline import glimmer_mg_pipe as pipe, scimm

    card = gpu_line()
    work = os.path.join(root, "mesh")
    os.makedirs(work)
    fa = os.path.join(root, "reads.fa")
    fa_upper = os.path.join(root, "upper", "reads.fa")
    phase6 = dir_files(os.path.join(root, "pipe"))
    phase6b_dir = os.path.join(root, "pipe_iter_warm")
    phase6b = dir_files(phase6b_dir)
    names = (phymm.raw_phymm_name(fa), phymm.results_name(fa))
    taxonomy = family_taxonomy(icm_dir)
    upper = list(read_fasta(fa_upper))
    init, clusters = scimm.init_clusters_from_results(
        os.path.join(phase6b_dir, names[1]), [h.split()[0] for h, _ in upper],
        taxonomy, minbp_pct=0.01,
        read_lengths=np.array([len(s) for _h, s in upper]))
    hist_numel = len(clusters) * 3 * 4 ** 7 * 11 * 16  # level 7, int64
    k1 = k2 = 0

    t_a = time.perf_counter()
    backend = pmesh.default_backend(DEVICE)
    with launcher_env(1, 0, free_port()):
        assert pmesh.init_distributed(device=DEVICE)
    try:
        assert dist.get_backend() == backend, dist.get_backend()
        mesh = pmesh.make_mesh(1, 1, device=DEVICE)
        dev = pmesh.rank_device(DEVICE)
        out = os.path.join(work, "classify_1x1")
        os.makedirs(out)
        icm_cuda.reset_launches()
        with last_k2() as k2_last, raw_matrices() as rt:
            t0 = time.perf_counter()
            phymm.classify_file(fa, icm_dir, out_dir=out, device=dev,
                                mesh=mesh)
            torch.cuda.synchronize()
            wall_c = time.perf_counter() - t0
        count_raw_text("mesh", rt)
        k2_c = icm_cuda.bank_walk_launches
        got = dir_files(out)
        same_c = all(got[n] == phase6[n] for n in names)
        same_k2, shape, k2_ms = k2_check(k2_last)
        log(f"11a classify_file on the 1x1 mesh ({backend}, {dev}): raw "
            f"matrix and results table "
            f"{'byte-identical' if same_c else 'DIFFER'} to phase 6's; K2 "
            f"launches {k2_c}; K2 on the rank's last shard {shape} vs twin: "
            f"{'bitwise equal' if same_k2 else 'DIFFER'}; wall "
            f"{wall_c:.4f} s; {card}")
        assert same_c and same_k2 and k2_c > 0
        k2 += k2_c

        icm_cuda.reset_launches()
        t0 = time.perf_counter()
        assign, icms, cscores = scimm.scimm_cluster(
            [s for _h, s in upper], init, len(clusters), device=dev,
            mesh=mesh)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        k2_s = icm_cuda.bank_walk_launches
        out = os.path.join(work, "scimm_1x1")
        os.makedirs(out)
        scimm.write_cluster_artifacts(out, upper, assign, icms, cscores)
        got, want = cluster_files(out), cluster_files(phase6b_dir)
        same_s = got == want and len(want) == 3 * len(clusters)
        log(f"11a scimm_cluster on the 1x1 mesh: {len(want)} cluster files "
            f"{'byte-identical' if same_s else 'DIFFER'} to phase 6b's; K2 "
            f"launches {k2_s}; wall {wall_s:.4f} s; {card}")
        assert same_s and k2_s > 0
        k2 += k2_s

        icm_cuda.reset_launches()
        t0 = time.perf_counter()
        with raw_matrices() as rt:
            final = pipe.run_pipeline(fa_upper, icm_dir, device=dev,
                                      iterate=1, taxonomy=taxonomy,
                                      mesh=mesh,
                                      workdir=os.path.join(work, "pipe_1x1"))
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
        count_raw_text("mesh", rt)
        k1_p, k2_p = icm_cuda.launches, icm_cuda.bank_walk_launches
        got = dir_files(os.path.dirname(final))
        diff = sorted(n for n in set(got) | set(phase6b)
                      if got.get(n) != phase6b.get(n))
        log(f"11a run_pipeline(iterate=1) on the 1x1 mesh: {len(got)} files "
            f"({len(phase6b)} in phase 6b's warm run), "
            f"{'every one byte-identical' if not diff else f'DIFFER: {diff}'}"
            f"; K1 launches {k1_p}, K2 {k2_p}; wall {wall_p:.4f} s; {card}")
        assert not diff and k1_p > 0 and k2_p > 0
        k1, k2 = k1 + k1_p, k2 + k2_p

        hist = torch.zeros(hist_numel, dtype=torch.int64, device=dev)

        def all_reduce():
            dist.all_reduce(hist)
            torch.cuda.synchronize()

        log(f"11a timing, 1 rank, so no scaling figure: K2 ms on the rank's "
            f"last shard {shape} (CUDA events, median of 5) {k2_ms:.4f}; "
            f"all-reduce of the {8 * hist_numel}-byte level-7 histogram on "
            f"the world group ({backend}, host clock, median of 3) "
            f"{host_ms(all_reduce, 3):.4f} ms (the mesh's own groups have "
            f"one rank and skip it); {card}")
    finally:
        pmesh.destroy()
    log(f"phase 11a: 1 rank on {backend}, {time.perf_counter() - t_a:.1f} s")

    t_b = time.perf_counter()
    with open(os.path.join(work, "spec.json"), "w") as fh:
        json.dump({"device": f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE,
                   "fa": fa, "fa_upper": fa_upper, "icm_dir": icm_dir,
                   "init": init.tolist(), "n_clusters": len(clusters),
                   "hist_numel": hist_numel, "reads": reads, "cmap": cmap},
                  fh)
    run_local([os.path.abspath(__file__), "--mesh-rank", work], MESH_RANKS,
              timeout=MESH_TIMEOUT)
    ranks = []
    for r in range(MESH_RANKS):
        with open(os.path.join(work, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    assert all(x["backend"] == "gloo" for x in ranks), ranks
    for data, model in ((1, 2), (2, 1)):
        tag = f"classify_file {data}x{model}"
        got = dir_files(os.path.join(work, f"cf_{data}x{model}"))
        same = all(got[n] == phase6[n] for n in names)
        k = [x["k2"][tag] for x in ranks]
        rts = [x["launches"][tag]["raw_text"] for x in ranks]
        log(f"11b {tag} (gloo, {MESH_RANKS} ranks on one card): raw matrix "
            f"and results table {'byte-identical' if same else 'DIFFER'} to "
            f"phase 6's, in the ranks' one directory; raw-text launches per "
            f"rank {[r['launches'] for r in rts]}; K2 "
            f"launches per rank {[x['launches'][tag]['K2'] for x in ranks]}"
            f"; each rank's K2 on its last shard "
            f"{[x['shape'] for x in k]} vs twin: "
            f"{'bitwise equal' if all(x['bitwise'] for x in k) else 'DIFFER'}")
        log(f"11b {tag} timing, {MESH_RANKS} ranks on one card, so no "
            f"scaling figure: wall per rank (s) "
            f"{[round(x['wall_s'][tag], 4) for x in ranks]}; K2 ms on each "
            f"rank's last shard (CUDA events, median of 5) "
            f"{[round(x['ms'], 4) for x in k]}; gather of a 512-read block ms "
            f"(host clock, median of 5) "
            f"{[round(x['gather_ms'], 4) for x in k]}; {card}")
        assert same
        assert all(x["bitwise"] for x in k)
        assert all(x["launches"][tag]["K2"] > 0 for x in ranks)
        k2 += sum(x["launches"][tag]["K2"] for x in ranks)
        if data == 1:  # rank 0 writes the one raw matrix, the kernel
            # rendering it
            assert all(r["written"] == (x["rank"] == 0)
                       for r, x in zip(rts, ranks)), rts
            count_raw_text("mesh", {k: sum(r[k] for r in rts)
                                    for k in rts[0]})
        else:  # each rank renders and writes its block of the ICM rows
            assert all(r == {"written": 0, "launches": 1} for r in rts), rts
            RAW_TEXT["mesh"] = RAW_TEXT.get("mesh", 0) + len(rts)

    tag = "EM 2x1"
    got = cluster_files(os.path.join(work, "em_2x1_rank0"))
    same = got == cluster_files(phase6b_dir) and len(got) > 0
    others = [dir_files(os.path.join(work, f"em_2x1_rank{r}"))
              for r in range(1, MESH_RANKS)]
    k = [x["k2"][tag] for x in ranks]
    log(f"11b scimm_cluster on the 2x1 mesh (gloo): {len(got)} cluster files "
        f"{'byte-identical' if same else 'DIFFER'} to phase 6b's, written by "
        f"rank 0 only: {not any(others)}; K2 launches per rank "
        f"{[x['launches'][tag]['K2'] for x in ranks]}; each rank's K2 on its "
        f"last shard {[x['shape'] for x in k]} vs twin: "
        f"{'bitwise equal' if all(x['bitwise'] for x in k) else 'DIFFER'}; "
        f"wall per rank (s) {[round(x['wall_s'][tag], 4) for x in ranks]}; "
        f"K2 ms per shard {[round(x['ms'], 4) for x in k]}; all-reduce of "
        f"the {8 * hist_numel}-byte level-7 histogram over the data group "
        f"(gloo through host memory, host clock, median of 3) ms "
        f"{[round(x['all_reduce_ms'], 4) for x in k]}; {card}")
    assert same and not any(others) and all(x["bitwise"] for x in k)
    assert all(x["launches"][tag]["K2"] > 0 for x in ranks)
    k2 += sum(x["launches"][tag]["K2"] for x in ranks)

    tag = "predict 2x1"
    pred = ranks[0]["predict"]
    with open(os.path.join(work, "predict_sharded.txt")) as fh:
        text = fh.read()
    served = set(predict_blocks(text))
    want = tmg.format_predict_mg([(h, g) for h, g in out5 if h in served])
    same = text == want
    log(f"11b data-sharded prediction of phase 5's {len(reads)} reads on the "
        f"2x1 mesh (gloo): gene records and event counts "
        f"{'equal' if pred['equal_to_unsharded'] else 'DIFFER'} to the "
        f"unsharded batches'; {pred['served']} device-served reads' .predict "
        f"{'byte-identical' if same else 'DIFFER'} to phase 5's; overflow "
        f"reads {pred['overflow_reads']} (phase 5: {overflow5}); K1 launches "
        f"per rank {[x['launches'][tag]['K1'] for x in ranks]}; each rank's "
        f"K1 on its widest shard {[x['k1']['shape'] for x in ranks]} (B, L, "
        f"G) vs twin: "
        f"{'bitwise equal' if all(x['k1']['bitwise'] for x in ranks) else 'DIFFER'}"
        f"; wall per rank (s) "
        f"{[round(x['wall_s'][tag], 4) for x in ranks]}; {card}")
    assert pred["equal_to_unsharded"] and same
    assert pred["overflow_reads"] == overflow5
    assert pred["served"] == len(reads) - overflow5
    assert all(x["k1"]["bitwise"] for x in ranks)
    assert all(x["launches"][tag]["K1"] > 0 for x in ranks)
    assert all(x["launches"][tag]["K3"] > 0 for x in ranks)
    assert all(x["launches"][tag]["KF"] > 0 for x in ranks)
    k1 += sum(x["launches"][tag]["K1"] for x in ranks)
    K3["paths"]["mesh"] = sum(x["launches"][tag]["K3"] for x in ranks)
    KF["paths"]["mesh"] = sum(x["launches"][tag]["KF"] for x in ranks)
    log(f"11b K3 launches per rank "
        f"{[x['launches'][tag]['K3'] for x in ranks]}, KF launches per rank "
        f"{[x['launches'][tag]['KF'] for x in ranks]}")
    log(f"phase 11b: {MESH_RANKS} ranks on gloo, "
        f"{time.perf_counter() - t_b:.1f} s")
    return k1, k2


BENCH_READS, BENCH_PASSES = 8192, 2  # phase 12's reads/s row
ACCURACY_BAR = 0.90  # tests/test_accuracy.py:57-64, the JAX package's


def bench_phase(root):
    """Phase 12: the port's bench (glimmer_mg_torch.bench) in this process,
    its cache in the smoke's temporary root: the bench DB and the
    sample-run stand-in built, then the four rows at the command line's
    widths, the reads/s row at BENCH_READS tiled reads and BENCH_PASSES
    timed passes. Each row raises on a false parity flag or a kernel that
    did not launch; the phase also asserts them, K2's bound at each of the
    row's shapes, and only truth_genes > 100 of the accuracy row. Returns
    (K1's launches, K2's launches) over the rows."""
    import torch

    from glimmer_mg_torch import bench
    from glimmer_mg_torch.ops import icm_score
    from glimmer_mg_torch.pipeline.accuracy import parse_predict

    t_phase = time.perf_counter()
    sizes = bench.Sizes(reads=BENCH_READS, passes=BENCH_PASSES)
    cache = os.path.join(root, "bench")
    classes, db_root, sample_root, build_s = bench.prepare(cache, sizes)
    log(f"12 bench DB ({sizes.strains} strains x {sizes.strain_genes} "
        f"genes) and sample-run stand-in ({sizes.sample_genes} genes, "
        f"{sizes.sample_reads} reads) built in {build_s:.1f} s")
    calls = {}
    for run in ("run1", "run2"):
        with open(os.path.join(sample_root, "glimmer3", "results",
                               f"NC_000915.{run}.predict")) as fh:
            calls[run] = len(parse_predict(fh.read()).popitem()[1])
    log(f"12 stand-in gene calls: run1.predict {calls['run1']}, "
        f"run2.predict {calls['run2']} (gene_accuracy's truth) for "
        f"{sizes.sample_genes} planted genes")

    k2_row = bench.icm_bank_scoring(sample_root, DEVICE, sizes)
    log(json.dumps(k2_row))
    for case in (k2_row["detail"], k2_row["detail"]["bank256"]):
        assert case["bitwise_equal_twin"] and case["k2_launches"] > 0
        lm, pk, reads, lengths, model_len, depth = bench.build_inputs(
            sample_root, case["models"], case["batch"], DEVICE)
        rc = icm_score.revcomp_reads(reads, lengths)
        levels = sum(bank_walk_levels(lm, r, lengths, model_len, depth)
                     for r in (reads, rc))
        walks = 2 * case["models"] * int(lengths.sum())
        ops = levels * K2_OPS_PER_LEVEL + walks * K2_OPS_PER_WALK
        nbytes = (lm.nbytes + pk.nbytes + (reads.numel() + lengths.numel()
                  + reads.shape[0] * case["models"]) * 4)
        bound_ms, bound_by = bound(nbytes, ops)
        log(f"12 K2 (both strands) at B={case['batch']} L={bench.READ_LEN} "
            f"M={case['models']}: step {case['step_ms']:.4f} ms (median of "
            f"{bench.STEP_RUNS} x {bench.STEP_CALLS} calls, CUDA events); "
            f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB, "
            f"{ops / 1e9:.4f} G integer instructions: {walks} walks entering "
            f"{levels} levels) [{gpu_line()}]")

    t0 = time.perf_counter()
    with raw_matrices() as rt:
        acc_row = bench.gene_accuracy(sample_root, DEVICE, cache, sizes)
    count_raw_text("bench", rt)
    log(json.dumps(acc_row))
    acc = acc_row["detail"]
    log(f"12 gene_accuracy in {time.perf_counter() - t0:.1f} s: "
        f"sensitivity {acc['sensitivity']} precision {acc['precision']} "
        f"(the JAX package's bar {ACCURACY_BAR}, a finding here, not a "
        f"gate); truth genes {acc['truth_genes']}; K1 {acc['k1_launches']} "
        f"K2 {acc['k2_launches']} launches")
    assert acc["truth_genes"] > 100, acc
    assert acc["k1_launches"] > 0 and acc["k2_launches"] > 0, acc

    t0 = time.perf_counter()
    g3_row = bench.glimmer3_whole_genome(sample_root)
    log(json.dumps(g3_row))
    assert g3_row["detail"]["byte_identical_run1"]
    log(f"12 glimmer3_whole_genome in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    row = bench.glimmer_mg_reads_per_s(db_root, classes, sample_root, DEVICE,
                                       sizes)
    log(json.dumps(row))
    d = row["detail"]
    cfg, res = d["device_config"], d["device_resident"]
    assert cfg["byte_identical"] and res["coords_identical"], (cfg, res)
    assert cfg["k1_launches"] > 0 and res["k1_launches"] > 0, (cfg, res)
    assert res["k3_launches"] > 0 and acc["k3_launches"] > 0, (res, acc)
    assert res["kf_launches"] > 0 and acc["kf_launches"] > 0, (res, acc)
    K3["paths"]["bench"] = acc["k3_launches"] + res["k3_launches"]
    KF["paths"]["bench"] = acc["kf_launches"] + res["kf_launches"]
    full = bench.Sizes()
    log(f"12 glimmer_mg_reads_per_s on {d['reads']} tiled reads x "
        f"{sizes.passes} timed passes (the command line's {full.reads:,} x "
        f"{full.passes} would take "
        f"{full.reads / res['reads_per_s']:.1f} s a pass on the device "
        f"route at this run's rate) in {time.perf_counter() - t0:.1f} s: "
        f"native/host "
        f"{row['value']:.1f}, native/device {cfg['reads_per_s']:.1f}, "
        f"device (f32 carry) {res['reads_per_s']:.1f} reads/s [{gpu_line()}]")
    torch.cuda.synchronize()
    log(f"phase 12 (bench): {time.perf_counter() - t_phase:.1f} s")
    k1 = acc["k1_launches"] + cfg["k1_launches"] + res["k1_launches"]
    k2 = (k2_row["detail"]["k2_launches"]
          + k2_row["detail"]["bank256"]["k2_launches"] + acc["k2_launches"])
    return k1, k2


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
    ap.add_argument("--mesh-rank", metavar="DIR", default=None,
                    help=argparse.SUPPRESS)  # one of phase 11's ranks
    ap.add_argument("--kf-ab", action="append", default=[],
                    metavar="NAME=PATH", help="time KF alone against the "
                    "frontend source PATH (kernel_ab), instead of the smoke")
    ap.add_argument("--k3-ab", action="append", default=[],
                    metavar="NAME=PATH", help="time K3 alone against the "
                    "event-DP source PATH (kernel_ab), instead of the smoke")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA GPU; none is available")
    if args.mesh_rank:
        mesh_rank(args.mesh_rank)
        return
    if args.kf_ab or args.k3_ab:
        kernel_ab("kf" if args.kf_ab else "k3", args.kf_ab or args.k3_ab,
                  args)
        return

    from glimmer_mg_torch import _build
    from glimmer_mg_torch.engine import glimmer_mg as tmg
    from glimmer_mg_torch.ops import event_dp_cuda, frontend_cuda, icm_cuda
    from glimmer_mg_torch.parallel import phymm

    log(gpu_line())
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build()
    _build.lib()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds})")
    for line in ptxas_lines("event_dp", "event_dp_kernel"):
        log(f"K3 ptxas: {line}")
    for line in ptxas_lines("frontend", "frontend_kernel"):
        log(f"KF ptxas: {line}")

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
        k2_record, k2_int8_record = bankwalk_phase(bank, genomes, args.seed)
        rt_record = rawtext_phase(args.seed)

        reads, cmap = sample_reads(genomes, args.reads, args.seed + 3)
        # pass 1 (cold: model construction, bank build) with the counts
        tmg.reset_counters()
        icm_cuda.reset_launches()
        event_dp_cuda.reset_launches()
        frontend_cuda.reset_launches()
        t0 = time.perf_counter()
        out = list(tmg.run_glimmer_mg_classes(reads, gd, cmap,
                                              device=DEVICE))
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = icm_cuda.launches
        K3["paths"]["prediction"] = event_dp_cuda.launches
        KF["paths"]["prediction"] = frontend_cuda.launches
        counts = dict(tmg.counters)
        log(f"prediction path pass 1: {len(out)} reads in {cold:.2f} s; "
            f"K1 launches {launches}, K3 launches "
            f"{event_dp_cuda.launches}, KF launches "
            f"{frontend_cuda.launches}; routes {counts}")
        assert launches > 0, "the prediction path did not launch K1"
        assert event_dp_cuda.launches > 0, \
            "the prediction path did not launch K3"
        assert frontend_cuda.launches > 0, \
            "the prediction path did not launch KF"
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
                                               engine="host"))
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
        k2_int8_launches = icm_cuda.bank_walk_int8_launches
        del bank
        classify_warm(fa, icm_dir, root, len(reads),
                      sum(len(s) for _h, s in reads))
        k2_scimm, k1_repredict = iterate_phase(root, icm_dir, gd, reads,
                                               args.check)

        k1_paths = {"prediction": launches, "repredict": k1_repredict}
        k1_paths["subs"], subs_case = subs_phase(gd, genomes, args.reads,
                                                 args.check, args.seed + 11)
        k1_paths["indels"] = indel_phase(gd, genomes, args.reads,
                                         min(args.check, 64), args.seed + 13)
        t0 = time.perf_counter()
        k1_paths["native"] = routes_phase(
            gd, {"error-free": {"reads": reads, "cmap": cmap, "out": out,
                                "host": host, "kw": {}},
                 "subs mode": subs_case}, args.check)
        log(f"phase 9 (engine routes): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cli_phase(root, icm_dir, reads, cmap, out, fa)
        log(f"phase 10 (CLI): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        k1_paths["mesh"], k2_mesh = mesh_phase(root, icm_dir, reads, cmap,
                                               out, counts["overflow_reads"])
        log(f"phase 11 (mesh): {time.perf_counter() - t0:.1f} s")
        k1_paths["bench"], k2_bench = bench_phase(root)

    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "glimmer_mg_tpu")]
    assert not bad, f"JAX or JAX package modules were loaded: {bad[:5]}"
    record["launches"] = sum(k1_paths.values())
    record["launches_by_path"] = k1_paths
    k2_record["launches_by_path"] = {"classify": k2_launches,
                                     "scimm": k2_scimm, "mesh": k2_mesh,
                                     "bench": k2_bench}
    k2_record["launches"] = sum(k2_record["launches_by_path"].values())
    k2_int8_record["launches"] = k2_int8_launches
    k3_paths = {k: v for k, v in K3["paths"].items() if v}
    cases = K3["cases"]
    k3_record = {
        "name": "event_dp_traceback", "route": "cuda",
        "source": "glimmer_mg_torch/csrc/event_dp.cu",
        "replaces": "glimmer_mg_tpu/ops/device_predict.py:2210",
        "launches": sum(k3_paths.values()), "launches_by_path": k3_paths,
        "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
        **{k: cases["error_free_f64"][k] for k in ("ms", "plain_ms",
                                                   "bound_ms", "bound_by")},
        "library_ms": None, "cases": cases}
    kf_paths = {k: v for k, v in KF["paths"].items() if v}
    kf_cases = KF["cases"]
    kf_record = {
        "name": "frontend", "route": "cuda",
        "source": "glimmer_mg_torch/csrc/frontend.cu",
        "replaces": "glimmer_mg_tpu/ops/device_predict.py:2617",
        "launches": sum(kf_paths.values()), "launches_by_path": kf_paths,
        "max_abs_err": max(c["max_abs_err"] for c in kf_cases.values()),
        **{k: kf_cases["error_free_f64"][k] for k in ("ms", "plain_ms",
                                                      "bound_ms",
                                                      "bound_by")},
        "library_ms": None, "cases": kf_cases}
    rt_record["launches"] = sum(RAW_TEXT.values())
    rt_record["launches_by_path"] = dict(RAW_TEXT)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "kernel_ms", "kernel_ms_cold", "checked_ms", "launches_by_path",
            "cases")
    print(gpu_line())
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r} for r in
                                  (record, k2_record, k2_int8_record,
                                   k3_record, kf_record, rt_record)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
