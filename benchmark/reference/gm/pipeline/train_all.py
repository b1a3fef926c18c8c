# Frozen copy of glimmer_mg_torch/pipeline/train_all.py at commit ab5a5d3.
"""Genome model-database construction (train_all.py / double_icms.py /
informative_genomes.py equivalents).

For every genome: self-train gene models (long-orfs bootstrap -> ICM ->
glimmer3 predictions -> feature histograms via train_genome_data), plus the
whole-genome classification ICM (Phymm's <nc>.icm — trained on the raw
genomic sequence, used only for read classification). Pairwise "double"
ICMs concatenate the gene sets of nearby genomes (double_icms.py:74-98).
"""

from __future__ import annotations

import itertools
import os

from ..io.fasta import read_fasta
from ..models import dna, icm as icm_mod, icm_train
from . import extract as ex, long_orfs as lo, train_features as tf


def train_genome(seq: str, nc: str, out_dir: str, *, min_icm_bp: int = 2000,
                 circular: bool = True) -> None:
    """Build all per-genome model files under ``out_dir`` for replicon nc."""
    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.join(out_dir, nc)

    # whole-genome classification ICM (Phymm equivalent)
    m = icm_train.train_icm([dna.encode(seq.lower())])
    icm_mod.write_icm(m, prefix + ".icm")

    # self-trained gene models (g3-iterated steps 1-5)
    from ..engine import glimmer3 as g3

    lines, _ = lo.run_long_orfs(seq, entropy_cutoff=1.15, circular=circular)
    train_recs = list(ex.extract(seq, "\n".join(lines), skip_stop=True,
                                 is_circular=circular))
    strings = icm_train.prepare_training_strings(
        [s for _, s in train_recs], reverse=True
    )
    gm = icm_train.train_icm([dna.encode(s) for s in strings])
    res = list(g3.run_glimmer3([(nc, seq)], gm, logodds_fudge=-12))
    tf.train_genome_data(
        g3.format_predict(res), {nc: seq}, prefix, min_icm_bp=min_icm_bp
    )


def train_all(genomes: dict[str, str], icm_dir: str, *, min_icm_bp: int = 2000,
              update_only: bool = False) -> None:
    """genomes: {'strain|nc': sequence}. Builds <icm_dir>/<strain>/<nc>.*"""
    for cls, seq in genomes.items():
        strain, nc = cls.split("|", 1)
        out_dir = os.path.join(icm_dir, strain)
        if update_only and os.path.exists(os.path.join(out_dir, nc + ".gicm")):
            continue
        train_genome(seq, nc, out_dir, min_icm_bp=min_icm_bp)


def double_icms(icm_dir: str, distances: dict | None = None, top: int = 5) -> None:
    """Pairwise double ICMs (double_icms.py): for each genome, train ICMs on
    the concatenated gene sets of its ``top`` nearest genomes. ``distances``
    maps (genomeA, genomeB) -> distance; all pairs when None."""
    import glob as _glob

    genomes = []
    for gf in _glob.glob(os.path.join(icm_dir, "*", "*.gene.fasta")):
        strain, fname = gf.split("/")[-2:]
        genomes.append(f"{strain}|{fname[:-len('.gene.fasta')]}")

    for g1 in genomes:
        if distances is not None:
            others = sorted(
                (g for g in genomes if g != g1),
                key=lambda g: distances.get((g1, g), distances.get((g, g1), 1e9)),
            )[:top]
        else:
            others = [g for g in genomes if g != g1][:top]
        for g2 in others:
            a, b = (g1, g2) if g1 < g2 else (g2, g1)
            st1, nc1 = a.split("|", 1)
            st2, nc2 = b.split("|", 1)
            out_dir = os.path.join(icm_dir, st1, nc1 + "_2", st2)
            out_path = os.path.join(out_dir, nc2 + ".gicm")
            if os.path.exists(out_path):
                continue
            recs = []
            for g in (a, b):
                st, nc = g.split("|", 1)
                recs.extend(
                    s for _, s in read_fasta(os.path.join(icm_dir, st, nc + ".gene.fasta"))
                )
            strings = icm_train.prepare_training_strings(recs, reverse=True)
            strings = [s for s in strings if len(s) >= 12]
            if not strings:
                continue
            os.makedirs(out_dir, exist_ok=True)
            m = icm_train.train_icm([dna.encode(s) for s in strings])
            icm_mod.write_icm(m, out_path)
