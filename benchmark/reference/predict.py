"""The plain reference of the predict cells: the exact per-read host
engine (frozen copies of the port's ``engine/mg_host.py`` and what it
uses) on per-read Models that it mixes again from the database files
(the frozen ``classes_models`` over the frozen ``GenomeData``), and the
comparison with what the program emitted.

The frozen mixing is the port's own code at ab5a5d3. What holds it to
glimmer-mg independently: ``tests/test_torch_glimmer_mg.py::
test_classes_mode_matches_host_engine`` (the port's classes mode, every
third read in two classes, against the JAX package's exact host engine:
coordinates identical, output text byte-identical) and
``tests/test_classes_mode.py`` (the JAX package's classes mode against
the glimmer-mg binary, where its sources are present).
"""

from __future__ import annotations

import multiprocessing
import os

import numpy as np

from .gm.engine.classes import classes_models
from .gm.engine.mg_host import _predict_read_with_models
from .gm.io.genome_data import GenomeData
from .gm.models import dna


# the reference's worker processes: the cores this process may use (a
# machine's os.cpu_count() may count its host's), at most 8
WORKERS = min(8, len(os.sched_getaffinity(0)))


def reference_genes(gd, classes, seq, quals, *, allow_subs, icm_cache):
    """The genes of one read of glimmer-mg's classes mode with the
    default options (min gene length 75, overlap 50, linear reads)."""
    models = classes_models(
        classes, len(seq), gd, parsed=None, user_icm=None, user_gc=None,
        user_rbs_pwm=None, user_stop_codons=None,
        fudge_f32=np.float32(1.0), min_gene_len=75, max_olap_bases=50,
        circular=False, icm_cache=icm_cache)
    return _predict_read_with_models(
        models, dna.encode(seq), quals, allow_subs=allow_subs,
        have_qual_file=quals is not None)


def gene_key(g):
    """Everything of a gene record but its score."""
    return (g.id, g.start, g.stop, g.frame, bool(g.truncated),
            tuple((e.pos, e.type) for e in (g.errors or ())))


def plain(genes):
    """A read's gene records as plain (key, score) pairs."""
    return [(gene_key(g), float(g.score)) for g in genes]


def _part(args):
    """Score gaps of one part of the sample: None for a read whose
    records differ, else [(gap, reference score)] a gene."""
    icm_dir, items, allow_subs = args
    gd, cache, out = GenomeData(icm_dir), {}, []
    for seq, classes, quals, got in items:
        want = plain(reference_genes(gd, classes, seq, quals,
                                     allow_subs=allow_subs, icm_cache=cache))
        if [k for k, _s in got] != [k for k, _s in want]:
            out.append(None)
            continue
        out.append([(abs(a - b), b) for (_k, a), (_k2, b) in zip(got, want)])
    return out


def compare(icm_dir, items, *, allow_subs, processes=None):
    """``items``: (sequence, classes, qualities or None, the program's
    genes as ``plain`` pairs). Returns the numbers compared,
    {"genes_differ": reads whose gene records differ in number,
    coordinates, frame, id, truncation or substitution records,
    "mean_score_gap": the mean gap between a gene's score and the
    reference's, "widest_score_gap": the widest, both over the genes of
    the reads whose records agree}, and diagnostics (the genes compared,
    the widest gap as a share of the reference's score).

    The sample is split by each read's first class over ``processes``
    worker processes (``WORKERS``; spawned, so they share nothing with
    the program), so that a worker loads few entries' files."""
    processes = max(1, min(processes or WORKERS, len(items)))
    order = sorted(range(len(items)), key=lambda i: items[i][1][0])
    bounds = np.linspace(0, len(order), processes + 1).astype(int)
    parts = [[items[i] for i in order[a:b]]
             for a, b in zip(bounds[:-1], bounds[1:])]
    args = [(icm_dir, p, allow_subs) for p in parts if p]
    if len(args) == 1:
        results = [_part(args[0])]
    else:
        pool = multiprocessing.get_context("spawn").Pool(len(args))
        try:
            results = pool.map(_part, args)
        finally:
            pool.close()
            pool.join()
    reads = [r for res in results for r in res]
    gaps = [g for r in reads if r is not None for g in r]
    d = np.array([g for g, _b in gaps], np.float64)
    ref = np.array([b for _g, b in gaps], np.float64)
    # a NaN stays NaN in the sum and the maximum and fails every limit
    res = {"genes_differ": sum(r is None for r in reads),
           "mean_score_gap": float(d.sum() / len(d)) if len(d) else 0.0,
           "widest_score_gap": float(np.max(d)) if len(d) else 0.0}
    rel = d / np.maximum(np.abs(ref), 1.0)
    return res, {"genes": len(d),
                 "relative_gap": float(np.max(rel)) if len(d) else 0.0}
