# Frozen copy of classes_models from glimmer_mg_torch/engine/glimmer_mg.py at
# commit ab5a5d3, with the module imports it uses.
"""Per-read Models of glimmer-mg's classes mode (the port's
``engine.glimmer_mg.classes_models``): the class mixing of the length,
start, adjacency and RBS models, the null ICM and the gene ICM."""

from __future__ import annotations

import math

import numpy as np

from ..models import dna, icm as icm_mod
from . import orfs as orf_mod
from .glimmer3 import Models


def classes_models(classes, n, genome_data, *, parsed, user_icm, user_gc,
                   user_rbs_pwm, user_stop_codons, fudge_f32, min_gene_len,
                   max_olap_bases, circular, icm_cache):
    """Per-read Models of classes mode (Update_Meta_*,
    glimmer-mg.cc:2050-2359): class length/start/adjacency distributions
    averaged (log-space for lengths), the null ICM rebuilt from the mean
    class GC, stop codons from the top class's translation table, the RBS
    a mixture of class PWMs, the gene ICM the classes' best ICM file
    (``GenomeData.classes_icm_file``).

    The same construction as the JAX package's run_glimmer_mg_classes,
    with the pure-Python log_add loop for the length mixture.
    """
    from ..io import features_file
    from ..io.genome_data import STOP_CODONS_BY_CODE
    from ..utils.mathutils import log_add
    from .glimmer3 import set_ignore_score_len

    if user_icm is not None:
        gene_icm = user_icm
    else:
        icm_file = genome_data.classes_icm_file(classes)
        gene_icm = icm_cache.get(icm_file)
        if gene_icm is None:
            gene_icm = icm_mod.read_icm_cached(icm_file)
            icm_cache[icm_file] = gene_icm

    if user_stop_codons is not None:
        stop_codons = user_stop_codons
    else:
        code = genome_data.transl_table(classes[0])
        stop_codons = STOP_CODONS_BY_CODE.get(code, dna.DEFAULT_STOP_CODONS)
    patterns = orf_mod.CodonPatterns.make(None, stop_codons)

    if user_icm is not None:
        gc = user_gc
    else:
        gc = 0.0
        for c in classes:
            gc += genome_data.gc(c)
        gc /= np.float32(len(classes))
    indep = icm_mod.build_indep_wo_stops(gc, patterns.stop_codons)

    models = Models(
        gene_icm=gene_icm, indep_model=indep, patterns=patterns,
        indep_gc_frac=gc, min_gene_len=min_gene_len,
        max_olap_bases=max_olap_bases, allow_truncated_orfs=not circular,
        circular=circular,
    )
    models.ignore_score_len = set_ignore_score_len(gc, patterns.stop_codons)
    num = np.float32(len(classes))

    # length + prior (Update_Meta_Length)
    if parsed is not None and parsed.user_length:
        models.logodds_prior = parsed.logodds_prior
        models.logodds_length = parsed.logodds_length
    else:
        prior = fudge_f32
        mixed_gene = None
        mixed_non = None
        for c in classes:
            gene_l, non_l, cls_prior = genome_data.lengths(c, min_gene_len)
            prior = np.float32(prior + cls_prior / num)
            if mixed_gene is None:
                mixed_gene = np.full(len(gene_l), -np.inf)
                mixed_non = np.full(len(non_l), -np.inf)
            for l in range(len(gene_l)):
                mixed_gene[l] = log_add(mixed_gene[l], gene_l[l])
            for l in range(len(non_l)):
                mixed_non[l] = log_add(mixed_non[l], non_l[l])
        mixed_gene -= math.log(float(num))
        mixed_non -= math.log(float(num))
        models.logodds_prior = prior
        models.logodds_length = features_file._length_make_log_odds(
            mixed_gene, mixed_non, [n // 3], min_gene_len)

    # starts (Update_Meta_Start)
    if parsed is not None and parsed.user_start:
        models.logodds_start = parsed.logodds_start
    else:
        sg = np.zeros(3, dtype=np.float32)
        sn = np.zeros(3, dtype=np.float32)
        for c in classes:
            g, nn = genome_data.starts(c)
            sg = (sg + g / num).astype(np.float32)
            sn = (sn + nn / num).astype(np.float32)
        models.logodds_start.make_log_odds(sg, sn)

    # adjacency (Update_Meta_Adj)
    if parsed is not None and parsed.user_adj:
        models.logodds_adj_or = parsed.logodds_adj_or
        models.logodds_adj_dist = parsed.logodds_adj_dist
    else:
        aog = np.zeros(4, dtype=np.float32)
        aon = np.zeros(4, dtype=np.float32)
        mixed_ad: dict = {}
        for c in classes:
            g, nn = genome_data.adj_orients(c)
            aog = (aog + g / num).astype(np.float32)
            aon = (aon + nn / num).astype(np.float32)
            for key, d in genome_data.adj_dists(c, max_olap_bases).items():
                if key not in mixed_ad:
                    mixed_ad[key] = np.zeros(len(d), dtype=np.float32)
                mixed_ad[key] = (mixed_ad[key] + d / num).astype(np.float32)
        models.logodds_adj_or.make_log_odds(aog, aon)
        models.logodds_adj_dist.max_overlap = max_olap_bases
        for key in ("ff", "fr", "rf"):
            models.logodds_adj_dist.make_log_odds(
                key, mixed_ad.get((key, "genes")), mixed_ad.get((key, "non")))

    # RBS mixture (Update_Meta_RBS) or user PWM
    if user_rbs_pwm is not None:
        models.logodds_pwm = user_rbs_pwm.make_log_odds_wrt_gc(gc)
        models.user_rbs = True
        models._meta_pwms = None
    else:
        models._meta_pwms = [genome_data.rbs_pwm(c) for c in classes]
    return models
