"""glimmer-mg per-read prediction with the device path in PyTorch.

Counterpart of the device half of ``glimmer_mg_tpu.engine.glimmer_mg``
(``_device_dp_chunk``, ``device_frame_scores_dispatch/finish``,
``_native_predict``, ``_overlap_engine``, ``_engine_pool``,
``run_glimmer_mg``, ``run_glimmer_mg_classes``). The host half (Models,
the exact per-read host engine, output formatting, the classes emission
order) is the port's own copy in ``engine.glimmer3`` and
``engine.mg_host``; the native C++ engine is ``glimmer_mg_torch.native``.

The caller picks the route with ``engine=``; nothing picks one by itself:
  * "device" (the default): error-free and substitution chunks, with or
    without qualities, run the device DP on ``device`` (six-frame kernel,
    frontend, event DP, traceback); indel chunks run the native engine;
  * "native": every chunk runs the native C++ engine on the host;
  * "host": every chunk runs the exact host engine
    (``_predict_read_with_models``), the reference the others are held to.
The native engine takes its six-frame scores from ``precompute=``:
"device" (the default) runs the six-frame kernel on ``device`` (its twin
on the CPU) and ships the f64 gene-minus-null tables to the host; "host"
lets the engine run its own walk. The JAX package chooses between its
device DP and its native engine by calibrated throughput
(``_use_device_dp``: 10,800 reads/s a host core against 3,500 a chip);
on a host of 8 cores and one card that rule would pick the native engine.

Routing is counted in ``counters``:
  * device_reads: reads predicted by the device DP;
  * native_reads: reads predicted by the native engine;
  * host_reads: reads predicted by the exact host engine, either because
    the caller asked for it (``engine="host"``), or because the whole
    chunk is outside the device and native routes' scope (circular
    genomes, models that cannot share one bank), or because the read
    overflowed the device capacities (more than MAX_EVENTS events, more
    than MAX_GENES genes, or the DP's row window);
  * overflow_reads: the overflow subset of host_reads.
Unclassified reads (classes mode) yield [] and are not counted. The native
engine has no fallback: when it is disabled or cannot be built, a call
that needs it raises.

With the recorder of ``utils.observe`` on, the layers record spans (on
the thread that runs them): ``predict.models`` (``classes_models``),
``predict.chunk_batch``, ``predict.bank_build``, ``predict.bank_upload``,
``predict.k1``, ``predict.kf``, ``predict.k3``, ``predict.fetch`` (the
blocking download of K3's outputs), ``predict.finish`` (``finish_genes``),
``predict.host_engine`` and ``predict.wait`` (the main thread blocked on
the worker's chunk); and counters ``models_cache_hit`` / ``_miss``,
``bank_cache_hit`` / ``_miss`` and ``frame_bank_cache_hit`` / ``_miss``.

One chunk stays in flight, as in the JAX package: while the main thread
builds chunk k+1's Models (and, on the native route, launches its
six-frame kernel), chunk k's device DP, or its score copy and native
engine call, runs on one module-level worker thread. An exception there
re-raises in the caller; output order and counters do not depend on it.
``GLIMMER_MG_TPU_OVERLAP=0/1`` turns it off or on; by default it is on
with at least 4 host cores.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import math
import os
import threading
from collections import OrderedDict

import numpy as np
import torch

from .. import native as native_mod
from ..models import dna, icm as icm_mod
from ..ops import device_predict as dpk
from ..ops import icm_cuda, icm_score
from ..utils import observe
from . import orfs as orf_mod
from .glimmer3 import Models
from .mg_host import (
    _bucket, _lru_put, _predict_read_with_models, _stable_tag,
    classes_emission_order, format_predict_mg,
)

__all__ = ["run_glimmer_mg", "run_glimmer_mg_classes", "format_predict_mg",
           "counters", "reset_counters", "ENGINES", "PRECOMPUTES"]

ENGINES = ("device", "native", "host")
PRECOMPUTES = ("device", "host")

counters = {"device_reads": 0, "native_reads": 0, "host_reads": 0,
            "overflow_reads": 0}


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


def _check_route(engine, precompute) -> None:
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if precompute not in PRECOMPUTES:
        raise ValueError(f"precompute must be one of {PRECOMPUTES}, got "
                         f"{precompute!r}")


# Banks are cached within one run_* call only: a bank bakes in the call's
# options (min_gene_len, max_olap_bases, user ICM, fudge, RBS, stop codons),
# which the model tags do not carry.
_BANK_CAP = 8


def _model_tag(models):
    return getattr(models, "_cache_tag", None) or _stable_tag(models, "m")


def _cached(bank_cache, key, build, counter):
    """``bank_cache[key]``, made by ``build()`` on a miss (None is not
    cached); counts ``<counter>_hit`` or ``<counter>_miss``."""
    hit = bank_cache.get(key)
    if hit is not None:
        observe.count(counter + "_hit")
        bank_cache.move_to_end(key)
        return hit
    observe.count(counter + "_miss")
    hit = build()
    if hit is not None:
        _lru_put(bank_cache, key, hit, _BANK_CAP)
    return hit


def _kernel_probs(mip, probs):
    """The prob tables the six-frame kernel reads: on the card, with the
    pruned back-up folded in (a walk enters a node only through a parent
    whose mip is >= 0, which the fold leaves as it is, so the twin reads
    them alike); on the CPU, as they are."""
    if mip.device.type == "cuda":
        return icm_cuda.fold_pruned_probs(mip, probs)
    return probs


def _bank_for(rows, models_list, l_pad, device, bank_cache):
    """(bank, its device tensors) for one chunk, from the call's LRU
    ``bank_cache`` keyed by (model tags ``rows``, length bucket). The
    six-frame tables' ranges are checked once, before the upload. Spans
    ``predict.bank_build`` and ``predict.bank_upload`` (with the fold);
    counters ``bank_cache_hit``, ``bank_cache_miss``."""
    def build():
        with observe.span("predict.bank_build", rows=len(rows)):
            bank = dpk.build_bank(models_list, max_read_len=l_pad)
            icm_cuda.check_tables(bank.gene_mip, bank.indep_mip, bank.depth)
        with observe.span("predict.bank_upload"):
            dev = dpk.bank_to_device(bank, device)
            for mip, probs in (("gene_mip", "gene_probs"),
                               ("indep_mip", "indep_probs")):
                dev[probs] = _kernel_probs(dev[mip], dev[probs])
        return bank, dev

    return _cached(bank_cache, (tuple(rows), l_pad), build, "bank_cache")


def _chunk_batch(jobs, row_key, device):
    """A chunk as the six-frame kernel takes it: its distinct bank rows
    and its reads on ``device``. Returns (row keys, one Models per row,
    reads (b_pad, l_pad) int32, lengths (b_pad,), row of each read
    (b_pad,)), reads in input order padded to _bucket(l, 256) x
    _bucket(b, 64). Bases, lengths and rows are range-checked here, on
    the host, so the kernel call makes no host sync.

    A row is one distinct ``row_key(models)``; rows are in key order, not
    first-seen order, so that chunks holding the same rows share one
    cached bank. Span ``predict.chunk_batch``."""
    with observe.span("predict.chunk_batch", reads=len(jobs)):
        key_of = {}
        for _s, m, _q, _hq in jobs:
            if id(m) not in key_of:
                key_of[id(m)] = row_key(m)
        rows = {}
        for _s, m, _q, _hq in jobs:
            rows.setdefault(key_of[id(m)], m)
        keys = sorted(rows, key=repr)
        index = {k: gi for gi, k in enumerate(keys)}

        l_pad = _bucket(max(len(s) for s, *_ in jobs))
        b_pad = _bucket(len(jobs), 64)
        reads = np.zeros((b_pad, l_pad), dtype=np.int32)
        lens = np.zeros(b_pad, dtype=np.int32)
        grp = np.zeros(b_pad, dtype=np.int32)
        for r, (seq_idx, m, _q, _hq) in enumerate(jobs):
            reads[r, : len(seq_idx)] = seq_idx
            lens[r] = len(seq_idx)
            grp[r] = index[key_of[id(m)]]
        icm_cuda.check_reads(reads, lens, grp, len(keys))
        return (keys, [rows[k] for k in keys],
                *(torch.from_numpy(a).to(device) for a in (reads, lens, grp)))


def _host_predict(jobs, allow_indels=False, allow_subs=False):
    """The exact host engine (span ``predict.host_engine``)."""
    counters["host_reads"] += len(jobs)
    with observe.span("predict.host_engine", reads=len(jobs)):
        return [_predict_read_with_models(m, s, q, allow_indels=allow_indels,
                                          allow_subs=allow_subs,
                                          have_qual_file=hq)
                for s, m, q, hq in jobs]


def _in_scope(jobs):
    """Whether a chunk's models suit the device and native routes: linear
    reads with truncated ORFs allowed."""
    return all(not m.circular and m.allow_truncated_orfs
               for _s, m, _q, _hq in jobs)


def _quals_tensor(jobs, b_pad, l_pad, device):
    """(b_pad, l_pad) uint8 per-base qualities of a chunk on ``device``,
    or None when no read has a quality file: values min(q, 254), 255 in
    rows without a quality file and past a read's end (the default
    probability of ``_CP_TAB``)."""
    if not any(hq and q is not None for _s, _m, q, hq in jobs):
        return None
    arr = np.full((b_pad, l_pad), 255, np.uint8)
    for r, (_s, _m, q, hq) in enumerate(jobs):
        if hq and q is not None:
            qv = np.minimum(np.asarray(q[:l_pad], np.int64), 254)
            arr[r, : len(qv)] = qv.astype(np.uint8)
    return torch.from_numpy(arr).to(device)


def _device_dp_chunk(jobs, device, bank_cache, *, f64=True, allow_subs=False):
    """Predict one chunk of reads on ``device``, error-free or, with
    ``allow_subs``, in substitution mode (per-base qualities go up as
    uint8 for the reads that have a quality file; the error-free mode
    never reads them).

    jobs: [(seq_idx, models, quals, have_qual)]. Returns
    list[list[TracedGene]], or None when the chunk cannot share one device
    batch (circular or non-truncated models, non-uniform scalars).
    Overflowing reads are re-run on the host engine in the same mode.
    """
    if not _in_scope(jobs):
        return None
    rows, models_list, reads_t, lens_t, grp_t = _chunk_batch(
        jobs, _model_tag, device)
    b_pad, l_pad = reads_t.shape
    try:
        bank, dev_bank = _bank_for(rows, models_list, l_pad, device,
                                   bank_cache)
    except ValueError:
        return None

    # on the card the bank's prob tables are the folded ones (_bank_for);
    # the CPU route ignores folded=
    with observe.span("predict.k1"):
        gene6, ind6 = icm_cuda.mg_six_frame(
            dev_bank["gene_mip"], dev_bank["gene_probs"],
            dev_bank["indep_mip"], dev_bank["indep_probs"], reads_t, lens_t,
            grp_t, model_len=bank.model_len, depth=bank.depth,
            gene_periodicity=bank.periodicity,
            folded=(dev_bank["gene_probs"], dev_bank["indep_probs"]),
            ranges_checked=True)
    quals_t = (_quals_tensor(jobs, b_pad, l_pad, device) if allow_subs
               else None)
    outs = dpk.predict_batch_device(bank, dev_bank, reads_t, lens_t, grp_t,
                                    gene6, ind6, f64=f64, subs=allow_subs,
                                    quals=quals_t)
    with observe.span("predict.finish"):
        genes, overflow = dpk.finish_genes(outs, len(jobs))
    n_over = 0
    for r, job in enumerate(jobs):
        if overflow[r]:
            # in the call's error mode: overflowing reads of a subs chunk
            # keep their substitution records
            genes[r] = _host_predict([job], allow_subs=allow_subs)[0]
            n_over += 1
    counters["overflow_reads"] += n_over
    counters["device_reads"] += len(jobs) - n_over
    return genes


def _frame_row(models):
    """A Models' row in the native route's six-frame bank: its gene ICM by
    identity and its null ICM by content (classes mode builds a null ICM
    for every Models, the same for reads of the same classes), so the rows
    are at most the chunk's class combinations."""
    null = models.indep_model
    digest = hashlib.blake2b(null.mip.tobytes() + null.probs.tobytes(),
                             digest_size=16).digest()
    return _stable_tag(models.gene_icm, "icm"), digest


def _frame_bank_for(rows, models_list, device, bank_cache):
    """(ICM bank tables on ``device``, model_len, depth, periodicity) of
    the six-frame kernel for a native-route chunk, from the call's cache
    keyed by the rows; None when the gene ICMs differ in model length or
    periodicity. The tables' ranges are checked once, before the
    upload."""
    def build():
        genes = [m.gene_icm for m in models_list]
        g0 = genes[0]
        if any(g.model_len != g0.model_len or g.periodicity != g0.periodicity
               for g in genes):
            return None
        depth = max(g.model_depth for g in genes)
        tables = (*icm_score.stack_bank(genes),
                  *icm_score.stack_bank([m.indep_model for m in models_list]))
        icm_cuda.check_tables(tables[0], tables[2], depth)
        gm, gp, im, ip = (torch.from_numpy(a).to(device) for a in tables)
        tabs = (gm, _kernel_probs(gm, gp), im, _kernel_probs(im, ip))
        return tabs, g0.model_len, depth, g0.periodicity

    return _cached(bank_cache, ("frames",) + tuple(rows), build,
                   "frame_bank_cache")


def _frame_scores_dispatch(jobs, device, bank_cache):
    """The launch half of the native route's six-frame scores (the
    counterpart of ``device_frame_scores_dispatch``): the six-frame kernel
    on ``device`` (its twin on the CPU), then on the same device the f64
    gene-minus-null differences at each read's own positions only, packed
    read after read as (6, n) with the forward frames reversed (as the
    engine reads them), and on the card a non-blocking copy of them into
    pinned host memory and an event behind it. No host sync. Returns the
    handle that :func:`_frame_scores_finish` takes, or None when the chunk
    cannot share one kernel call."""
    rows, models_list, reads_t, lens_t, grp_t = _chunk_batch(
        jobs, _frame_row, device)
    fb = _frame_bank_for(rows, models_list, device, bank_cache)
    if fb is None:
        return None
    tabs, model_len, depth, periodicity = fb
    with observe.span("predict.k1"):
        gene6, ind6 = icm_cuda.mg_six_frame(
            *tabs, reads_t, lens_t, grp_t, model_len=model_len, depth=depth,
            gene_periodicity=periodicity, folded=(tabs[1], tabs[3]),
            ranges_checked=True)

    lens = [len(s) for s, *_rest in jobs]
    off6 = np.zeros(len(jobs), np.int64)
    np.cumsum([6 * n for n in lens[:-1]], out=off6[1:])
    total = 6 * sum(lens)
    # flat element k belongs to read r (the last whose offset is <= k; an
    # empty read owns none), frame f, output position p
    k = torch.arange(total, device=device)
    off6_t = torch.from_numpy(off6).to(device)
    r = torch.searchsorted(off6_t, k, right=True) - 1
    local = k - off6_t[r]
    n = lens_t.to(torch.int64)[r]
    f = local // n
    p = local - f * n
    pos = torch.where(f < 3, n - 1 - p, p)
    src = (r * 6 + f) * reads_t.shape[1] + pos
    diff = (gene6.reshape(-1)[src].to(torch.float64)
            - ind6.reshape(-1)[src].to(torch.float64))
    event = None
    if diff.device.type == "cuda":
        host = torch.empty(total, dtype=torch.float64, pin_memory=True)
        host.copy_(diff, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        diff = host
    return diff, event, lens


def _frame_scores_finish(handle):
    """The blocking half (the counterpart of
    ``device_frame_scores_finish``): wait for the copy, then cut each
    read's (6, n) f64 table out of the packed scores (views, no copy):
    frames 0..2 forward and 3..5 reverse, each the gene-minus-null
    log-prob, as the native engine reads them."""
    flat, event, lens = handle
    if event is not None:
        event.synchronize()
    flat = flat.numpy()
    out, off = [], 0
    for n in lens:
        out.append(flat[off:off + 6 * n].reshape(6, n))
        off += 6 * n
    return out


def _native_predict(jobs, fs_list, allow_indels=False, allow_subs=False):
    """Run a chunk through the port's native C++ engine, on the frame
    scores ``fs_list`` or, with None, on the engine's own walk. Raises
    RuntimeError when the engine is disabled or cannot be built: no quiet
    fall-back onto the Python engine."""
    try:
        native_mod.get_lib()
        njobs = []
        for r, (s, m, q, hq) in enumerate(jobs):
            # the marshalled tables live as long as the Models
            nm = getattr(m, "_native_marshal", None)
            if nm is None:
                nm = m._native_marshal = native_mod.NativeModels(m)
            njobs.append((s, q, hq, None if fs_list is None else fs_list[r],
                          nm))
    except native_mod.NativeUnavailable as exc:
        raise RuntimeError(f"the native route needs the native engine, "
                           f"which is unavailable: {exc}") from exc
    genes = native_mod.predict_batch(njobs, allow_indels=allow_indels,
                                     allow_subs=allow_subs)
    counters["native_reads"] += len(jobs)
    return genes


def _overlap_engine() -> bool:
    """Whether chunk k runs on the worker thread while the main thread
    prepares chunk k+1 (the JAX package's rule): ``GLIMMER_MG_TPU_OVERLAP``
    = 0/1 decides; otherwise on with at least 4 host cores (the JAX
    package measured a 20% loss on 2 cores, where the worker competes
    with the native engine's threads)."""
    env = os.environ.get("GLIMMER_MG_TPU_OVERLAP")
    if env is not None:
        return env != "0"
    return (os.cpu_count() or 1) >= 4


_ENGINE_POOL = None
_ENGINE_POOL_LOCK = threading.Lock()


def _engine_pool():
    """The one worker thread that runs chunks behind the main thread.
    Module-level, so that abandoned generators leak no threads; one
    worker keeps chunks in order. It only ever runs bounded chunk jobs,
    so interpreter exit, which joins it, cannot hang on it."""
    global _ENGINE_POOL
    with _ENGINE_POOL_LOCK:
        if _ENGINE_POOL is None:
            from concurrent.futures import ThreadPoolExecutor

            _ENGINE_POOL = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="gmt-engine")
        return _ENGINE_POOL


class _ChunkRouter:
    """One call's chunk router. ``submit`` runs on the main thread: it
    picks a chunk's route and, on the native route with
    ``precompute="device"``, launches the six-frame kernel. ``_run`` does
    the rest (the device DP, or the score copy's finish and the native
    engine, or the host engine), on the worker thread when ``overlap``,
    else in ``collect``. Each bank cache is touched by one thread only:
    the device DP's by ``_run``, the six-frame bank's by ``submit``."""

    def __init__(self, device, *, engine, precompute, allow_indels,
                 allow_subs, f64):
        _check_route(engine, precompute)
        if device.type == "cuda" and device.index is None:
            # the worker thread starts on device 0, so name the card
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.engine, self.precompute = engine, precompute
        self.allow_indels, self.allow_subs, self.f64 = (allow_indels,
                                                        allow_subs, f64)
        self.dp_banks: OrderedDict = OrderedDict()
        self.frame_banks: OrderedDict = OrderedDict()
        self.overlap = _overlap_engine()
        self.inflight: collections.deque = collections.deque()

    def _route(self, jobs):
        if not jobs:
            return "none"
        if self.engine == "host" or not _in_scope(jobs):
            return "host"
        if self.allow_indels or self.engine == "native":
            return "native"
        return "device"

    def submit(self, jobs):
        route, fut = self._route(jobs), None
        if route == "native" and self.precompute == "device":
            fut = _frame_scores_dispatch(jobs, self.device, self.frame_banks)
            if fut is None:
                route = "host"  # the gene ICMs cannot share one kernel call
        task = (route, jobs, fut)
        self.inflight.append(_engine_pool().submit(self._run, task)
                             if self.overlap else task)

    def collect(self):
        """The oldest submitted chunk's genes (re-raises its exception);
        span ``predict.wait``, the main thread blocked on the worker."""
        task = self.inflight.popleft()
        if not self.overlap:
            return self._run(task)
        with observe.span("predict.wait"):
            return task.result()

    def _run(self, task):
        route, jobs, fut = task
        with (torch.cuda.device(self.device) if self.device.type == "cuda"
              else contextlib.nullcontext()):
            if route == "none":
                return []
            if route == "device":
                genes = _device_dp_chunk(jobs, self.device, self.dp_banks,
                                         f64=self.f64,
                                         allow_subs=self.allow_subs)
                if genes is not None:
                    return genes
            elif route == "native":
                fs = None if fut is None else _frame_scores_finish(fut)
                return _native_predict(jobs, fs, self.allow_indels,
                                       self.allow_subs)
            return _host_predict(jobs, self.allow_indels, self.allow_subs)


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


def run_glimmer_mg_classes(
    sequences,  # list of (header, seq)
    genome_data,  # io.genome_data.GenomeData
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
    engine: str = "device",
    precompute: str = "device",
):
    """glimmer-mg classification mode (-c): per-read model
    parameterization, predicted on ``device``. Yields (header,
    [TracedGene]) in the reference's emission order.

    ``engine`` ("device", "native" or "host") and ``precompute`` ("device"
    or "host") pick the route (module docstring); ``engine="host"`` serves
    every read with the exact host engine, the reference the other routes
    are held to."""
    from ..io import features_file
    from .glimmer3 import gc_fraction

    device = _check_device(device)
    if allow_indels and allow_subs:
        raise ValueError("cannot use indels and subs simultaneously")
    router = _ChunkRouter(device, engine=engine, precompute=precompute,
                          allow_indels=allow_indels, allow_subs=allow_subs,
                          f64=f64)
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
    chunks: collections.deque = collections.deque()  # submitted, in order

    def flush(final=False):
        router.submit([(s, m, q, hq) for _h, s, m, q, hq in pending
                       if m is not None])
        chunks.append(list(pending))
        pending.clear()
        # one chunk stays in flight while the next one is prepared
        while len(chunks) > (0 if final else 1):
            genes = iter(router.collect())
            for header, _s, models, _q, _hq in chunks.popleft():
                yield header, (next(genes) if models is not None else [])

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
                observe.count("models_cache_miss")
                with observe.span("predict.models"):
                    models = classes_models(
                        classes, n, genome_data, parsed=parsed,
                        user_icm=user_icm, user_gc=user_gc,
                        user_rbs_pwm=user_rbs_pwm,
                        user_stop_codons=user_stop_codons,
                        fudge_f32=fudge_f32, min_gene_len=min_gene_len,
                        max_olap_bases=max_olap_bases, circular=circular,
                        icm_cache=icm_cache)
                models._cache_tag = gd_tag + cache_key
                model_cache[cache_key] = models
            else:
                observe.count("models_cache_hit")
            quals = qualities.get(prefix) if qualities is not None else None
            pending.append((header, dna.encode(seq), models, quals,
                            quals is not None))
        if len(pending) >= chunk_size:
            yield from flush()
    yield from flush(final=True)


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
    engine: str = "device",
    precompute: str = "device",
):
    """glimmer-mg with a user ICM (-m mode), predicted on ``device``.
    Yields (header, [TracedGene]). ``engine`` and ``precompute`` pick the
    route as in :func:`run_glimmer_mg_classes`."""
    from ..io import features_file
    from .glimmer3 import gc_fraction, set_ignore_score_len

    device = _check_device(device)
    if allow_indels and allow_subs:
        raise ValueError("cannot use indels and subs simultaneously")
    router = _ChunkRouter(device, engine=engine, precompute=precompute,
                          allow_indels=allow_indels, allow_subs=allow_subs,
                          f64=f64)

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
    chunks: collections.deque = collections.deque()

    def flush(final=False):
        router.submit([(s, models, q, hq) for _h, s, q, hq in pending])
        chunks.append([h for h, *_rest in pending])
        pending.clear()
        while len(chunks) > (0 if final else 1):
            yield from zip(chunks.popleft(), router.collect())

    for header, seq in sequences:
        quals = None
        if qualities is not None:
            quals = qualities.get(header.split()[0])
        pending.append((header, dna.encode(seq), quals, quals is not None))
        if len(pending) >= chunk_size:
            yield from flush()
    yield from flush(final=True)
