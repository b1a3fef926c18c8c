"""glimmer-mg per-read prediction with the device path in PyTorch.

Counterpart of the device half of ``glimmer_mg_tpu.engine.glimmer_mg``
(``_device_dp_chunk``, ``run_glimmer_mg``, ``run_glimmer_mg_classes``).
The host half (Models, the exact per-read host engine, output formatting,
the classes emission order) is imported from the JAX package, which keeps
its JAX imports out of those functions.

Routing is explicit and counted in ``counters``:
  * device_reads: reads predicted on ``device`` (six-frame kernel, frontend,
    event DP, traceback);
  * host_reads: reads predicted by the exact host engine
    (``_predict_read_with_models``), either because the caller asked for
    it (``host_engine=True``), or because the whole chunk is outside the
    device path's scope (indel or substitution mode, circular genomes,
    models that cannot share one bank), or because the read
    overflowed the device capacities (more than MAX_EVENTS events, more
    than MAX_GENES genes, or the DP's row window);
  * overflow_reads: the overflow subset of host_reads.
Unclassified reads (classes mode) yield [] and are not counted.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch

from glimmer_mg_tpu.engine import orfs as orf_mod
from glimmer_mg_tpu.engine.glimmer3 import Models
from glimmer_mg_tpu.engine.glimmer_mg import (
    _bucket, _lru_put, _predict_read_with_models, _stable_tag,
    classes_emission_order, format_predict_mg,
)
from glimmer_mg_tpu.models import dna, icm as icm_mod

from ..ops import device_predict as dpk
from ..ops import icm_cuda

__all__ = ["run_glimmer_mg", "run_glimmer_mg_classes", "format_predict_mg",
           "counters", "reset_counters"]

counters = {"device_reads": 0, "host_reads": 0, "overflow_reads": 0}


def reset_counters() -> None:
    for k in counters:
        counters[k] = 0


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


# Banks are cached within one run_* call only: a bank bakes in the call's
# options (min_gene_len, max_olap_bases, user ICM, fudge, RBS, stop codons),
# which the model tags do not carry.
_BANK_CAP = 8


def _model_tag(models):
    return getattr(models, "_cache_tag", None) or _stable_tag(models, "m")


def _bank_for(models_list, l_pad, device, bank_cache):
    """(bank, its device tensors) for one chunk, from the call's LRU
    ``bank_cache`` keyed by (model tags, length bucket)."""
    key = (tuple(_model_tag(m) for m in models_list), l_pad)
    hit = bank_cache.get(key)
    if hit is not None:
        bank_cache.move_to_end(key)
        return hit
    bank = dpk.build_bank(models_list, max_read_len=l_pad)
    hit = (bank, dpk.bank_to_device(bank, device))
    _lru_put(bank_cache, key, hit, _BANK_CAP)
    return hit


def _host_predict(jobs, allow_indels=False, allow_subs=False):
    """The exact host engine."""
    counters["host_reads"] += len(jobs)
    return [_predict_read_with_models(m, s, q, allow_indels=allow_indels,
                                      allow_subs=allow_subs,
                                      have_qual_file=hq)
            for s, m, q, hq in jobs]


def _device_dp_chunk(jobs, device, bank_cache, *, f64=True):
    """Predict one chunk of error-free reads on ``device``.

    jobs: [(seq_idx, models, quals, have_qual)]. Returns
    list[list[TracedGene]], or None when the chunk cannot share one device
    batch (circular or non-truncated models, non-uniform scalars).
    Overflowing reads are re-run on the host engine.
    """
    for _s, models, _q, _hq in jobs:
        if models.circular or not models.allow_truncated_orfs:
            return None
    # bank rows in tag order, not first-seen order, so that chunks holding
    # the same models share one cached bank
    uniq = {id(m): m for _s, m, _q, _hq in jobs}
    models_list = sorted(uniq.values(), key=lambda m: repr(_model_tag(m)))
    index = {id(m): gi for gi, m in enumerate(models_list)}
    group = np.array([index[id(m)] for _s, m, _q, _hq in jobs],
                     dtype=np.int32)

    # reads in input order, padded to _bucket(l, 256) x _bucket(b, 64)
    lengths = np.array([len(s) for s, *_ in jobs], dtype=np.int32)
    l_pad = _bucket(int(lengths.max(initial=1)))
    b_pad = _bucket(len(jobs), 64)
    try:
        bank, dev_bank = _bank_for(models_list, l_pad, device, bank_cache)
    except ValueError:
        return None

    reads = np.zeros((b_pad, l_pad), dtype=np.int32)
    for r, (seq_idx, *_rest) in enumerate(jobs):
        reads[r, : len(seq_idx)] = seq_idx
    lens = np.zeros(b_pad, dtype=np.int32)
    lens[: len(jobs)] = lengths
    grp = np.zeros(b_pad, dtype=np.int32)
    grp[: len(jobs)] = group
    reads_t = torch.from_numpy(reads).to(device)
    lens_t = torch.from_numpy(lens).to(device)
    grp_t = torch.from_numpy(grp).to(device)

    gene6, ind6 = icm_cuda.mg_six_frame(
        dev_bank["gene_mip"], dev_bank["gene_probs"], dev_bank["indep_mip"],
        dev_bank["indep_probs"], reads_t, lens_t, grp_t,
        model_len=bank.model_len, depth=bank.depth,
        gene_periodicity=bank.periodicity)
    outs = dpk.predict_batch_device(bank, dev_bank, reads_t, lens_t, grp_t,
                                    gene6, ind6, f64=f64)
    genes, overflow = dpk.finish_genes(outs, len(jobs))
    n_over = 0
    for r, job in enumerate(jobs):
        if overflow[r]:
            genes[r] = _host_predict([job])[0]
            n_over += 1
    counters["overflow_reads"] += n_over
    counters["device_reads"] += len(jobs) - n_over
    return genes


def _chunk_predictor(device, *, allow_indels, allow_subs, f64, host_engine):
    """One call's chunk router, with the call's own bank cache: the device
    path when in scope, else the host engine."""
    bank_cache: OrderedDict = OrderedDict()

    def predict(jobs):
        if not jobs:
            return []
        # indel and substitution modes are outside this port's device path
        if not (allow_indels or allow_subs or host_engine):
            genes = _device_dp_chunk(jobs, device, bank_cache, f64=f64)
            if genes is not None:
                return genes
        return _host_predict(jobs, allow_indels, allow_subs)

    return predict


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
    from glimmer_mg_tpu.engine.glimmer3 import set_ignore_score_len
    from glimmer_mg_tpu.io import features_file
    from glimmer_mg_tpu.io.genome_data import STOP_CODONS_BY_CODE
    from glimmer_mg_tpu.utils.mathutils import log_add

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


def run_glimmer_mg_classes(
    sequences,  # list of (header, seq)
    genome_data,  # glimmer_mg_tpu.io.genome_data.GenomeData
    classifications: dict,  # header prefix -> [class strings]
    *,
    device,
    qualities: dict | None = None,
    user_icm: icm_mod.ICM | None = None,
    features_path=None,
    user_rbs_pwm=None,
    logodds_fudge: float | None = None,
    min_gene_len: int = 75,
    max_olap_bases: int = 50,
    allow_indels: bool = False,
    allow_subs: bool = False,
    circular: bool = False,
    user_stop_codons=None,
    f64: bool = True,
    chunk_size: int = 2048,
    host_engine: bool = False,
):
    """glimmer-mg classification mode (-c): per-read model
    parameterization, predicted on ``device``. Yields (header,
    [TracedGene]) in the reference's emission order.

    ``host_engine=True`` serves every read with the exact host engine, the
    reference the device path is held to."""
    from glimmer_mg_tpu.engine.glimmer3 import gc_fraction
    from glimmer_mg_tpu.io import features_file

    device = _check_device(device)
    if allow_indels and allow_subs:
        raise ValueError("cannot use indels and subs simultaneously")
    predict = _chunk_predictor(device, allow_indels=allow_indels,
                               allow_subs=allow_subs, f64=f64,
                               host_engine=host_engine)
    fudge_f32 = np.float32(1.0 if logodds_fudge is None else logodds_fudge)

    parsed = None
    if features_path is not None:
        parsed = features_file.parse_features(
            features_path, min_gene_len=min_gene_len,
            max_olap_bases=max_olap_bases,
            sequence_aa_lengths=[len(s) // 3 for _, s in sequences],
            logodds_fudge=logodds_fudge)

    sequences = list(sequences)
    user_gc = None
    if user_icm is not None:
        user_gc = gc_fraction([s for _, s in sequences])
        iter_sequences = sequences
    else:
        by_prefix = {h.split()[0]: (h, s) for h, s in sequences}
        iter_sequences = [
            by_prefix[p]
            for p in classes_emission_order(genome_data, classifications)
            if p in by_prefix
        ]

    icm_cache: dict = {}
    model_cache: dict = {}
    gd_tag = ("cls", _stable_tag(genome_data, "gd"))
    pending: list = []  # (header, seq_idx or None, models, quals, have_qual)

    def flush():
        jobs = [(s, m, q, hq) for _h, s, m, q, hq in pending if m is not None]
        genes = iter(predict(jobs))
        for header, _s, models, _q, _hq in pending:
            yield header, (next(genes) if models is not None else [])
        pending.clear()

    for header, seq in iter_sequences:
        prefix = header.split()[0]
        classes = classifications.get(prefix)
        if not classes:
            pending.append((header, None, None, None, False))
        else:
            n = len(seq)
            cache_key = (tuple(classes),
                         n if parsed is None or not parsed.user_length else 0)
            models = model_cache.get(cache_key)
            if models is None:
                models = classes_models(
                    classes, n, genome_data, parsed=parsed, user_icm=user_icm,
                    user_gc=user_gc, user_rbs_pwm=user_rbs_pwm,
                    user_stop_codons=user_stop_codons, fudge_f32=fudge_f32,
                    min_gene_len=min_gene_len, max_olap_bases=max_olap_bases,
                    circular=circular, icm_cache=icm_cache)
                models._cache_tag = gd_tag + cache_key
                model_cache[cache_key] = models
            quals = qualities.get(prefix) if qualities is not None else None
            pending.append((header, dna.encode(seq), models, quals,
                            quals is not None))
        if len(pending) >= chunk_size:
            yield from flush()
    yield from flush()


def run_glimmer_mg(
    sequences,  # list of (header, seq)
    gene_icm: icm_mod.ICM,
    *,
    device,
    qualities: dict | None = None,
    features_path=None,
    rbs_pwm=None,
    gc_frac: float | None = None,
    logodds_fudge: float | None = None,
    min_gene_len: int = 75,
    max_olap_bases: int = 50,
    allow_indels: bool = False,
    allow_subs: bool = False,
    circular: bool = False,
    start_codons=None,
    stop_codons=None,
    f64: bool = True,
    chunk_size: int = 2048,
    host_engine: bool = False,
):
    """glimmer-mg with a user ICM (-m mode), predicted on ``device``.
    Yields (header, [TracedGene]). ``host_engine=True`` serves every read
    with the exact host engine."""
    from glimmer_mg_tpu.engine.glimmer3 import (
        gc_fraction, set_ignore_score_len,
    )
    from glimmer_mg_tpu.io import features_file

    device = _check_device(device)
    if allow_indels and allow_subs:
        raise ValueError("cannot use indels and subs simultaneously")
    predict = _chunk_predictor(device, allow_indels=allow_indels,
                               allow_subs=allow_subs, f64=f64,
                               host_engine=host_engine)

    patterns = orf_mod.CodonPatterns.make(start_codons, stop_codons)
    if gc_frac is None:
        gc_frac = gc_fraction([s for _, s in sequences])
    indep = icm_mod.build_indep_wo_stops(gc_frac, patterns.stop_codons)
    models = Models(
        gene_icm=gene_icm, indep_model=indep, patterns=patterns,
        indep_gc_frac=gc_frac, min_gene_len=min_gene_len,
        max_olap_bases=max_olap_bases, allow_truncated_orfs=not circular,
        circular=circular,
    )
    models.logodds_prior = np.float32(-1.0)
    if logodds_fudge is not None:
        models.logodds_prior = np.float32(
            models.logodds_prior + np.float32(logodds_fudge))
    models.ignore_score_len = set_ignore_score_len(gc_frac,
                                                   patterns.stop_codons)

    if features_path is not None:
        parsed = features_file.parse_features(
            features_path, min_gene_len=min_gene_len,
            max_olap_bases=max_olap_bases,
            sequence_aa_lengths=[len(s) // 3 for _, s in sequences],
            logodds_fudge=logodds_fudge)
        if parsed.logodds_prior is not None:
            models.logodds_prior = parsed.logodds_prior
        if parsed.logodds_length is not None:
            models.logodds_length = parsed.logodds_length
        if parsed.logodds_start is not None:
            models.logodds_start = parsed.logodds_start
        if parsed.logodds_adj_or is not None:
            models.logodds_adj_or = parsed.logodds_adj_or
            models.logodds_adj_dist = parsed.logodds_adj_dist

    if rbs_pwm is not None:
        models.logodds_pwm = rbs_pwm.make_log_odds_wrt_gc(gc_frac)
        models.user_rbs = True

    pending: list = []

    def flush():
        jobs = [(s, models, q, hq) for _h, s, q, hq in pending]
        genes = predict(jobs)
        for (header, *_rest), g in zip(pending, genes):
            yield header, g
        pending.clear()

    for header, seq in sequences:
        quals = None
        if qualities is not None:
            quals = qualities.get(header.split()[0])
        pending.append((header, dna.encode(seq), quals, quals is not None))
        if len(pending) >= chunk_size:
            yield from flush()
    yield from flush()
