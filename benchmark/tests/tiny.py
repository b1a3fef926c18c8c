"""A tiny copy of the benchmark for CPU tests: the real operations and
metric readers, a 10-entry database of two 40-kb genomes, short reads."""

from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DB = {"entries": 10, "trained_genomes": 2, "genome_bp": 40000,
      "gc_low": 0.35, "gc_high": 0.6, "neighbours": 5, "perturb_sd": 0.01,
      "database_seed": 7}
QUALITY = {"start": 38, "end": 26, "sd": 3.0, "dip_rate": 0.05,
           "dip_max": 15, "min": 2, "max": 41}


def config(name, errors=None, length=None):
    return {"name": name, "source": "tiny", **DB,
            "reads": {"length": length or {"mean": 420, "sd": 60,
                                           "min": 300, "max": 520},
                      "revcomp": 0.5, "classes": 3, "abundance_sigma": 2.0,
                      "abundance_seed": 3,
                      "errors": errors}}


TRAFFIC = {
    "tpredict": {"operation": "predict", "pool_reads": 160,
                 "warmup_reads": 40, "check_reads": 6,
                 "options": {"chunk_size": 32}},
    "tsubs": {"operation": "predict", "pool_reads": 160, "warmup_reads": 40,
              "check_reads": 6,
              "options": {"allow_subs": True, "chunk_size": 32}},
    "tclassify": {"operation": "classify", "pool_reads": 96,
                  "file_reads": 40, "warmup_reads": 20, "check_per_file": 4,
                  "check_file_share": 0.5,
                  "fasta_width": 60},
}
CELLS = {
    "tiny-predict": ("tiny", "tpredict",
                     {"genes_differ": 0, "mean_score_gap": 4e-7,
                      "widest_score_gap": 3.5e-6}),
    "tiny_hiseq-subs": ("tiny_hiseq", "tsubs",
                        {"genes_differ": 0, "mean_score_gap": 4e-7,
                         "widest_score_gap": 3.5e-6}),
    "tiny-classify": ("tiny", "tclassify",
                      {"ids_wrong": 0, "raw_gap": 0.5, "table_gap": 0.5,
                       "best_gap": 0.5}),
}


def make(root, cache=None):
    """A bench directory under ``root`` holding the tiny cells; the
    database cache is shared through ``cache`` when given."""
    for d in ("ops", "metrics"):
        shutil.copytree(os.path.join(BENCH, d), os.path.join(root, d),
                        ignore=shutil.ignore_patterns("__pycache__"))
    for d in ("configs", "traffic", "workloads"):
        os.makedirs(os.path.join(root, d))

    def dump(kind, name, obj):
        with open(os.path.join(root, kind, name + ".json"), "w") as fh:
            json.dump(obj, fh)

    dump("configs", "tiny", config("tiny"))
    dump("configs", "tiny_hiseq", config(
        "tiny_hiseq", {"kind": "substitutions_from_quality",
                       "quality": QUALITY}, {"fixed": 270}))
    for name, t in TRAFFIC.items():
        dump("traffic", name, t)
    for name, (cfg, tr, limits) in CELLS.items():
        dump("workloads", name, {"config": cfg, "traffic": tr, "chips": 1,
                                 "limits": limits})
    if cache is not None:
        os.symlink(cache, os.path.join(root, ".cache"))
    return root
