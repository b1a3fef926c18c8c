"""Full glimmer-mg metagenomics pipeline on a chosen device.

Counterpart of ``glimmer_mg_tpu.pipeline.glimmer_mg_pipe`` (reference
scripts/glimmer-mg.py):
  1. Phymm classification (``parallel.phymm.classify_file``: the bank-walk
     kernel) -> rawPhymmOutput_*.txt, results.01.phymm_*.txt;
  2. top-k class parsing with the informative-genome filter ->
     <out>.class.txt;
  3. per-read prediction with those classes
     (``engine.glimmer_mg.run_glimmer_mg_classes``: the six-frame kernel) ->
     <out>.run1.predict;
  4. Scimm-style clustering (``pipeline.scimm``: the device EM, which
     retrains the cluster bank with ``ops.icm_train_device`` and scores it
     with the bank-walk kernel, or the host EM) -> cluster-<k>.fa,
     cluster-<k>.icm, icm-<k>.scores.tmp;
  5. per cluster: retraining from the cluster's initial predictions,
     reprediction with the retrained models (the six-frame kernel again)
     -> <out>.cluster-<k>.predict, and the cluster-vs-classification
     arbitration -> the final <out>.predict.
Each stage can resume from its files (--raw / --class / --clust
equivalents). Over a (data, model) mesh of ranks (``parallel.mesh``)
stages 1 and 4 are sharded, as in the JAX package; the output process
(rank 0) writes every file and runs stages 2, 3 and 5 alone, and the other
ranks wait for it at barriers.

``informative_genomes``, ``running_top_k``, ``parse_phymm``, ``_per_read``,
``filter_predictions``, ``keep_start_features_only``, ``repredict`` and
``combine_predictions`` are copies of the JAX package's (``repredict``
passes the device and the prediction route on): its module imports JAX.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..engine import glimmer_mg as mg
from ..engine.glimmer_mg import _check_device
from ..io.fasta import read_fasta
from ..io.genome_data import GenomeData, parse_classes
from ..parallel import mesh as pmesh, phymm
from ..utils.observe import StageTimers, profiler_trace
from . import scimm, train_features as tf

MIN_GENE_BP = 80000
MIN_CLUST_PHYMM_RATIO = -0.013


def informative_genomes(icm_dir: str, min_adj: float = 7.0) -> set[str]:
    """informative_genomes.py: genomes with a trained .gicm and >= min_adj
    adjacency observations in both mixed-orientation gene distance files."""
    out = set()
    for gicm in glob.glob(os.path.join(icm_dir, "*", "*.gicm")):
        pre = gicm[: -len(".gicm")]
        ok = True
        for sfx in (".adj_dist.1.-1.genes.txt", ".adj_dist.-1.1.genes.txt"):
            try:
                adjs = sum(float(l.split()[1]) for l in open(pre + sfx) if l.split())
            except OSError:
                adjs = 0.0
            if adjs < min_adj:
                ok = False
        if ok:
            strain, nc = pre.split("/")[-2:]
            out.add(f"{strain}|{nc}")
    return out


def running_top_k(scores: np.ndarray, k: int):
    """Per-row top-k slots with the reference's streaming insert semantics.

    The reference script builds each read's class list by streaming genome
    columns through a fixed-size slot list (glimmer-mg.py:536-605 with the
    insert routine at :669).  Those semantics are NOT a plain top-k sort:
    the first k columns fill the slots in column order (unsorted), and each
    later column is inserted before the first slot it strictly beats,
    shifting the rest right and dropping the LAST slot — which can discard
    a large value that the unsorted fill phase left in a late slot.  Class
    files only match the reference byte-for-byte if that quirk is kept, so
    this vectorizes the slot automaton itself, one O(reads x k) numpy step
    per column instead of a Python loop per cell.

    ``scores`` is (n_rows, n_cols) processed left to right.  Returns
    (slot_scores (n_rows, k) f64, slot_cols (n_rows, k) int; empty slots
    hold -inf / -1).
    """
    n, c = scores.shape
    slot_s = np.full((n, k), -np.inf)
    slot_c = np.full((n, k), -1, dtype=np.int64)
    j = np.arange(k)[None, :]
    for col in range(c):
        s = scores[:, col]
        if col < k:  # fill phase: slot index == column index, no sorting
            slot_s[:, col] = s
            slot_c[:, col] = col
            continue
        beats = s[:, None] > slot_s
        ip = np.where(beats.any(axis=1), beats.argmax(axis=1), k)[:, None]
        src = j - (j > ip)  # right-shift everything at/after the insert slot
        slot_s = np.take_along_axis(slot_s, src, axis=1)
        slot_c = np.take_along_axis(slot_c, src, axis=1)
        at = j == ip
        slot_s = np.where(at, s[:, None], slot_s)
        slot_c = np.where(at, col, slot_c)
    return slot_s, slot_c


def parse_phymm(raw_file, informative: set[str], top_hits: int = 3):
    """Per-read top-k informative genomes from the raw Phymm matrix
    (reference glimmer-mg.py:533).

    Returns (sequence_classes {read: [genome,...]}, top_scores {read: s}).
    """
    icm_paths, read_ids, scores = phymm.read_raw_phymm_output(raw_file)
    genomes = [phymm.path_to_genome(p) for p in icm_paths]
    inf_cols = [g for g, name in enumerate(genomes) if name in informative]
    slot_s, slot_c = running_top_k(scores[:, inf_cols], top_hits)
    sequence_classes = {}
    top_scores = {}
    for s, rid in enumerate(read_ids):
        top_scores[rid] = slot_s[s, 0] if slot_c[s, 0] >= 0 else -np.inf
        sequence_classes[rid] = [
            genomes[inf_cols[c]] for c in slot_c[s] if c >= 0
        ]
    return sequence_classes, top_scores


def _predict_to_text(results) -> str:
    return mg.format_predict_mg(results)


def _per_read(text: str) -> dict[str, list[str]]:
    out = {}
    cur = None
    for line in text.splitlines():
        if line.startswith(">"):
            cur = line[1:]
            out[cur] = []
        elif cur is not None:
            out[cur].append(line)
    return out


def filter_predictions(predict_text: str, filter_t: float) -> str:
    """glimmer-mg.py:397: keep rows with score > filter_t."""
    out = []
    for line in predict_text.splitlines():
        if line.startswith(">"):
            out.append(line)
        else:
            a = line.split()
            if a and float(a[4]) > filter_t:
                out.append(line)
    return "\n".join(out) + "\n"


def keep_start_features_only(features_text: str) -> str:
    """glimmer-mg.py retrain: keep only DIST START blocks (default mode)."""
    out = []
    printing = False
    for line in features_text.splitlines():
        if line.startswith("DIST START"):
            printing = True
        elif line.startswith("DIST"):
            printing = False
        if printing:
            out.append(line)
    return "\n".join(out) + "\n"


def repredict(reads, genome_data, classes, out_prefix, *, device,
              filter_t=1.0, all_features=False, indels=False, subs=False,
              qualities=None, initial_text=None, fudge=None,
              engine="device", precompute="device"):
    """glimmer-mg.py:613 repredict (one iteration): retrain from the
    previous predictions, then predict with the new models on ``device``
    on the route ``engine``/``precompute``
    (``engine.glimmer_mg.run_glimmer_mg_classes``)."""
    prev = f"{out_prefix}.run1"
    seqs = dict(reads)
    filt = filter_predictions(initial_text, filter_t)
    with open(f"{prev}.fpredict", "w") as fh:
        fh.write(filt)
    tf.train_features(filt, seqs, prev, indels=indels)
    if not all_features:
        feats = keep_start_features_only(open(f"{prev}.features.txt").read())
        with open(f"{prev}.features.txt", "w") as fh:
            fh.write(feats)

    from ..models import features as feat, icm as icm_mod

    gicm_path = f"{prev}.gicm"
    if not os.path.exists(gicm_path):
        return None  # too little training data; caller keeps initial
    gicm = icm_mod.read_icm(gicm_path)
    rbs = feat.PWM.read(f"{prev}.motif")
    rbs.counts_to_prob()
    rbs.probs_to_logs()
    res = list(
        mg.run_glimmer_mg_classes(
            reads, genome_data, classes,
            device=device,
            user_icm=gicm, user_rbs_pwm=rbs,
            features_path=f"{prev}.features.txt",
            qualities=qualities, allow_indels=indels, allow_subs=subs,
            logodds_fudge=fudge, engine=engine, precompute=precompute,
        )
    )
    text = _predict_to_text(res)
    with open(f"{out_prefix}.predict", "w") as fh:
        fh.write(text)
    return text


def combine_predictions(init_text, clust_text, clust_reads, cluster_scores,
                        top_scores, read_lengths, gene_bp):
    """glimmer-mg.py:310 combine_predictions for one cluster.

    Returns final text for the cluster's reads.
    """
    init_preds = _per_read(init_text)
    if gene_bp < MIN_GENE_BP or clust_text is None:
        out = []
        for h in clust_reads:
            out.append(f">{h}")
            out.extend(init_preds.get(h, []))
        return "\n".join(out) + "\n"

    clust_preds = _per_read(clust_text)
    out = []
    headers = set(list(clust_preds) + list(init_preds))
    for header in headers:
        prefix = header.split()[0]
        ratio = (cluster_scores[prefix] - top_scores[prefix]) / read_lengths[header]
        out.append(f">{header}")
        if ratio < MIN_CLUST_PHYMM_RATIO:
            out.extend(init_preds.get(header, []))
        else:
            out.extend(clust_preds.get(header, []))
    return "\n".join(out) + "\n"


def run_pipeline(
    sequence_file: str,
    icm_dir: str,
    out_prefix: str | None = None,
    *,
    device,
    top_hits: int = 3,
    iterate: int = 1,
    filter_t: float = 1.0,
    all_features: bool = False,
    indels: bool = False,
    subs: bool = False,
    quality_file: str | None = None,
    fudge: float | None = None,
    taxonomy: dict | None = None,
    minbp_pct: float = 0.01,
    workdir: str = ".",
    raw_done: bool = False,
    class_done: bool = False,
    clust_done: bool = False,
    time_files: bool = False,
    timers: StageTimers | None = None,
    cluster_device: bool | None = None,
    engine: str = "device",
    precompute: str = "device",
    profile_dir: str | None = None,
    mesh=None,
):
    """Full pipeline on ``device``; returns the final .predict path.

    ``iterate=0`` stops after the initial predictions (stages 1-3); the
    default ``iterate=1`` clusters the reads and repredicts each cluster
    (stages 4-5). Every prediction stage takes the route ``engine`` /
    ``precompute`` (``engine.glimmer_mg.run_glimmer_mg_classes``): by
    default error-free and substitution reads (``subs``, with or without
    ``quality_file``) are predicted on the device path; indel reads
    (``indels``) by the six-frame kernel on ``device``, then the native
    C++ engine on the host. ``cluster_device`` picks the EM route
    (``scimm.scimm_cluster``'s ``use_device``: ``None`` is the device EM
    on a CUDA device, the host EM on the CPU).

    Observability (SURVEY §5): ``timers`` collects per-stage wall-clock and
    reads/s / Mbp/s counters (stages ``phymm``, ``parse_phymm``, ``iter0``,
    ``cluster``, ``repredict``); ``time_files=True`` writes the reference's
    ``time_<out>_<stage>.txt`` files (scripts/glimmer-mg.py:43-47);
    ``profile_dir`` wraps the run in a torch.profiler trace
    (``utils.observe.profiler_trace``).

    ``mesh`` (a ``parallel.mesh`` mesh; ``device`` is then this rank's)
    shards classification (the bank over ``model``, the reads over
    ``data``) and the EM clustering (reads over ``data``, the cluster bank
    over ``model``), and implies the device EM unless ``cluster_device``
    says otherwise. Every rank returns the final path.
    """
    device = _check_device(device)
    mg._check_route(engine, precompute)
    timers = timers or StageTimers()
    with profiler_trace(profile_dir):
        final = _run_pipeline_timed(
            sequence_file, icm_dir, out_prefix, device=device,
            top_hits=top_hits, iterate=iterate, filter_t=filter_t,
            all_features=all_features, indels=indels, subs=subs,
            quality_file=quality_file, fudge=fudge, taxonomy=taxonomy,
            minbp_pct=minbp_pct, workdir=workdir, raw_done=raw_done,
            class_done=class_done, clust_done=clust_done, timers=timers,
            cluster_device=cluster_device, engine=engine,
            precompute=precompute, mesh=mesh,
        )
    if time_files and (mesh is None or pmesh.is_output_process()):
        pre = (out_prefix if out_prefix is not None
               else os.path.splitext(os.path.basename(sequence_file))[0])
        timers.write_time_files(pre, workdir)
    return final


def _run_pipeline_timed(
    sequence_file, icm_dir, out_prefix=None, *, device, top_hits=3,
    iterate=1, filter_t=1.0, all_features=False, indels=False, subs=False,
    quality_file=None, fudge=None, taxonomy=None, minbp_pct=0.01,
    workdir=".", raw_done=False, class_done=False, clust_done=False,
    timers: StageTimers, cluster_device=None, engine="device",
    precompute="device", mesh=None,
):
    os.makedirs(workdir, exist_ok=True)
    if out_prefix is None:
        out_prefix = os.path.splitext(os.path.basename(sequence_file))[0]
    reads = list(read_fasta(sequence_file))
    read_ids = [h.split()[0] for h, _ in reads]
    raw_file = os.path.join(workdir, phymm.raw_phymm_name(sequence_file))
    results_file = os.path.join(workdir, phymm.results_name(sequence_file))
    class_file = os.path.join(workdir, f"{out_prefix}.class.txt")

    qualities = None
    if quality_file:
        from ..io.fasta import read_qual

        qualities = {h.split()[0]: q for h, q in read_qual(quality_file)}

    total_bp = sum(len(s) for _, s in reads)

    # the unsharded stages write files, so with a mesh only the output
    # process runs them; the others wait at the barriers
    writer = mesh is None or pmesh.is_output_process()

    # 1. classify (resume: --raw)
    if not raw_done and not class_done:
        with timers.stage("phymm") as st:
            phymm.classify_file(sequence_file, icm_dir, out_dir=workdir,
                                device=device, taxonomy=taxonomy, mesh=mesh)
            st.items, st.bp = len(reads), total_bp
    pmesh.barrier()  # rank 0's results table is on disk for stage 4

    if writer:
        # 2. parse classifications (resume: --class)
        if not class_done:
            with timers.stage("parse_phymm"):
                informative = informative_genomes(icm_dir)
                classes, top_scores = parse_phymm(raw_file, informative,
                                                  top_hits)
                with open(class_file, "w") as fh:
                    for rid in classes:
                        fh.write("%s\t%s\n" % (rid, " ".join(classes[rid])))
        else:
            classes = parse_classes(class_file)
            icm_paths, rids, scores = phymm.read_raw_phymm_output(raw_file)
            top_scores = dict(zip(rids, scores.max(axis=1)))

        gd = GenomeData(icm_dir)

        # 3. initial predictions
        run1 = os.path.join(workdir, f"{out_prefix}.run1")
        with timers.stage("iter0") as st:
            init_res = list(
                mg.run_glimmer_mg_classes(
                    reads, gd, classes, device=device, qualities=qualities,
                    allow_indels=indels, allow_subs=subs,
                    logodds_fudge=fudge, engine=engine,
                    precompute=precompute,
                )
            )
            init_text = _predict_to_text(init_res)
            st.items, st.bp = len(reads), total_bp
        with open(f"{run1}.predict", "w") as fh:
            fh.write(init_text)

    if iterate == 0:
        final = os.path.join(workdir, f"{out_prefix}.predict")
        if writer:
            with open(final, "w") as fh:
                fh.write(init_text)
        pmesh.barrier()
        return final

    # 4. clustering (resume: --clust)
    seqs = [s for _, s in reads]
    if not clust_done:
        with timers.stage("cluster") as st:
            read_lengths_arr = np.array([len(s) for s in seqs])
            assign, names = scimm.init_clusters_from_results(
                results_file, read_ids, taxonomy, minbp_pct=minbp_pct,
                read_lengths=read_lengths_arr,
            )
            use_dev = cluster_device
            if use_dev is None and mesh is not None:
                use_dev = True
            assign, icms, cscores = scimm.scimm_cluster(
                seqs, assign, len(names), use_device=use_dev,
                device=device, mesh=mesh)
            if writer:
                scimm.write_cluster_artifacts(workdir, reads, assign, icms,
                                              cscores)
            st.items, st.bp = len(reads), total_bp

    final_path = os.path.join(workdir, f"{out_prefix}.predict")
    if not writer:
        pmesh.barrier()
        return final_path

    # 5. per-cluster reprediction + arbitration
    init_per_read = _per_read(init_text)
    read_lengths = {h: len(s) for h, s in reads}
    with timers.stage("repredict") as st, open(final_path, "w") as out_fh:
        st.items, st.bp = len(reads), total_bp
        for cfa in sorted(glob.glob(os.path.join(workdir, "cluster-*.fa"))):
            cluster = int(os.path.basename(cfa).split("-")[1].split(".")[0])
            c_reads = list(read_fasta(cfa))
            c_headers = [h for h, _ in c_reads]
            c_prefix = os.path.join(
                workdir, f"{out_prefix}.cluster-{cluster}"
            )
            c_init = []
            for h in c_headers:
                c_init.append(f">{h}")
                c_init.extend(init_per_read.get(h, []))
            c_init_text = "\n".join(c_init) + "\n"
            n_predictions = sum(
                1 for l in c_init_text.splitlines() if l and not l.startswith(">")
            )
            clust_text = None
            gene_bp = 0
            if n_predictions > 10:
                clust_text = repredict(
                    c_reads, gd, classes, c_prefix, device=device,
                    filter_t=filter_t, all_features=all_features,
                    indels=indels, subs=subs, qualities=qualities, fudge=fudge,
                    initial_text=c_init_text, engine=engine,
                    precompute=precompute,
                )
                gf = f"{c_prefix}.run1.gene.fasta"
                if os.path.exists(gf):
                    gene_bp = sum(
                        len(s) for h, s in read_fasta(gf)
                    )
            cscores_file = os.path.join(workdir, f"icm-{cluster}.scores.tmp")
            cluster_scores = {}
            with open(cscores_file) as fh:
                for line in fh:
                    h, sc = line.split("\t")
                    cluster_scores[h.rstrip()] = float(sc)
            out_fh.write(
                combine_predictions(
                    c_init_text, clust_text, c_headers, cluster_scores,
                    top_scores, read_lengths, gene_bp,
                )
            )
    pmesh.barrier()
    return final_path
