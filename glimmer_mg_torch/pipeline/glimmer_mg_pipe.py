"""glimmer-mg metagenomics pipeline, stages 1-3, on a chosen device.

Counterpart of ``glimmer_mg_tpu.pipeline.glimmer_mg_pipe`` (reference
scripts/glimmer-mg.py) up to the initial predictions:
  1. Phymm classification (``parallel.phymm.classify_file``: the bank-walk
     kernel) -> rawPhymmOutput_*.txt, results.01.phymm_*.txt;
  2. top-k class parsing with the informative-genome filter ->
     <out>.class.txt;
  3. per-read prediction with those classes
     (``engine.glimmer_mg.run_glimmer_mg_classes``: the six-frame kernel) ->
     <out>.run1.predict and the final <out>.predict.
Each stage can resume from its files (--raw / --class equivalents).
Scimm clustering and per-cluster reprediction (``iterate >= 1``) need
device ICM training and are not ported yet.

``informative_genomes``, ``running_top_k`` and ``parse_phymm`` are copies of
the JAX package's: its module imports JAX.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from glimmer_mg_tpu.io.fasta import read_fasta
from glimmer_mg_tpu.io.genome_data import GenomeData, parse_classes
from glimmer_mg_tpu.utils.observe import StageTimers

from ..engine import glimmer_mg as mg
from ..engine.glimmer_mg import _check_device
from ..parallel import phymm


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


def run_pipeline(
    sequence_file: str,
    icm_dir: str,
    out_prefix: str | None = None,
    *,
    device,
    top_hits: int = 3,
    iterate: int = 0,
    workdir: str = ".",
    raw_done: bool = False,
    class_done: bool = False,
    indels: bool = False,
    subs: bool = False,
    quality_file: str | None = None,
    fudge: float | None = None,
    taxonomy: dict | None = None,
    timers: StageTimers | None = None,
):
    """Pipeline stages 1-3 on ``device``; returns the final .predict path.

    ``timers`` collects per-stage wall-clock and reads/s / Mbp/s counters
    (stages ``phymm``, ``parse_phymm``, ``iter0``). Indel and substitution
    reads take the prediction engine's host route.
    """
    if iterate > 0:
        raise NotImplementedError(
            "iterate >= 1 (Scimm clustering and per-cluster reprediction) "
            "needs device ICM training, not ported yet (ROADMAP A8)")
    device = _check_device(device)
    timers = timers or StageTimers()
    os.makedirs(workdir, exist_ok=True)
    if out_prefix is None:
        out_prefix = os.path.splitext(os.path.basename(sequence_file))[0]
    reads = list(read_fasta(sequence_file))
    raw_file = os.path.join(workdir, phymm.raw_phymm_name(sequence_file))
    class_file = os.path.join(workdir, f"{out_prefix}.class.txt")

    qualities = None
    if quality_file:
        from glimmer_mg_tpu.io.fasta import read_qual

        qualities = {h.split()[0]: q for h, q in read_qual(quality_file)}

    total_bp = sum(len(s) for _, s in reads)

    # 1. classify (resume: --raw)
    if not raw_done and not class_done:
        with timers.stage("phymm") as st:
            phymm.classify_file(sequence_file, icm_dir, out_dir=workdir,
                                device=device, taxonomy=taxonomy)
            st.items, st.bp = len(reads), total_bp

    # 2. parse classifications (resume: --class)
    if not class_done:
        with timers.stage("parse_phymm"):
            informative = informative_genomes(icm_dir)
            classes, _top_scores = parse_phymm(raw_file, informative,
                                               top_hits)
            with open(class_file, "w") as fh:
                for rid in classes:
                    fh.write("%s\t%s\n" % (rid, " ".join(classes[rid])))
    else:
        classes = parse_classes(class_file)

    # 3. initial predictions
    gd = GenomeData(icm_dir)
    with timers.stage("iter0") as st:
        init_res = list(
            mg.run_glimmer_mg_classes(
                reads, gd, classes, device=device, qualities=qualities,
                allow_indels=indels, allow_subs=subs, logodds_fudge=fudge,
            )
        )
        init_text = mg.format_predict_mg(init_res)
        st.items, st.bp = len(reads), total_bp
    run1 = os.path.join(workdir, f"{out_prefix}.run1")
    with open(f"{run1}.predict", "w") as fh:
        fh.write(init_text)
    final = os.path.join(workdir, f"{out_prefix}.predict")
    with open(final, "w") as fh:
        fh.write(init_text)
    return final
