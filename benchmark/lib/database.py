"""The reference database every cell reads: Phymm/Glimmer-MG genome
entries in the ``.genomeData`` layout.

A few synthetic genomes are trained by a frozen copy of the port's
trainer (``reference.gm.pipeline.train_all.train_genome``); every other
entry is a seeded perturbed copy of one of them (its genome ICM and gene
ICM perturbed, its feature files copied), so that it costs what a trained
entry costs to load, mix and walk. The database is fixed by the config's
database keys, not by a run's seed: a deployment's database does not
change per sample.

The first run in a checkout builds it under ``<cache>/db-<key>``; ``key``
hashes the database keys and the code that builds it. Later runs find
the marker and load it.
"""

from __future__ import annotations

import contextlib
import fcntl
import glob
import hashlib
import json
import multiprocessing
import os
import shutil
from dataclasses import dataclass

import numpy as np

DB_KEYS = ("entries", "trained_genomes", "genome_bp", "gc_low", "gc_high",
           "neighbours", "perturb_sd", "database_seed")
NC = "chr"
# the files of an entry that GenomeData and PhymmBank read
FEATURE_SUFFIXES = (".motif", ".gc.txt", ".lengths.genes.txt",
                    ".lengths.non.txt", ".starts.genes.txt",
                    ".starts.non.txt", ".adj_orients.genes.txt",
                    ".adj_orients.non.txt") + tuple(
    f".adj_dist.{t}.{o}.txt" for t in ("1.1", "1.-1", "-1.1")
    for o in ("genes", "non"))

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


def code_hash() -> str:
    """Hash of the code that builds the database."""
    files = [os.path.join(HERE, "database.py"),
             os.path.join(BENCH, "traffic", "generators.py")]
    files += sorted(glob.glob(os.path.join(BENCH, "reference", "gm", "**",
                                           "*.py"), recursive=True))
    h = hashlib.sha256()
    for f in files:
        h.update(os.path.relpath(f, BENCH).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def params_of(cfg) -> dict:
    return {k: cfg[k] for k in DB_KEYS}


def entry_name(k: int, trained: int) -> str:
    return f"t{k}|{NC}" if k < trained else f"e{k:03d}|{NC}"


@dataclass
class Database:
    root: str
    icm_dir: str
    entries: list          # class string of entry k
    genome_of: np.ndarray  # trained genome behind entry k
    neighbours: np.ndarray  # (entries, n) fixed neighbours of entry k
    genome_flat: np.ndarray  # the trained genomes, lower case, one buffer
    genome_start: np.ndarray
    genome_len: np.ndarray


def _load(root) -> Database:
    with open(os.path.join(root, "meta.json")) as fh:
        meta = json.load(fh)
    seqs = []
    with open(os.path.join(root, "genomes.txt")) as fh:
        seqs = [line.strip() for line in fh if line.strip()]
    lens = np.array([len(s) for s in seqs], np.int64)
    starts = np.zeros(len(seqs), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    flat = np.frombuffer("".join(seqs).encode("ascii"), np.uint8).copy()
    return Database(root, os.path.join(root, "genomeData"), meta["entries"],
                    np.array(meta["genome_of"], np.int64),
                    np.array(meta["neighbours"], np.int64), flat, starts,
                    lens)


@contextlib.contextmanager
def _locked(path):
    with open(path, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def ensure(cfg, cache_root, log=print, processes=None) -> Database:
    """The database of the config ``cfg``, built under ``cache_root`` on
    first use."""
    params = params_of(cfg)
    key = hashlib.sha256((json.dumps(params, sort_keys=True) + code_hash())
                         .encode()).hexdigest()[:16]
    root = os.path.join(cache_root, f"db-{key}")
    marker = os.path.join(root, "READY")
    os.makedirs(cache_root, exist_ok=True)
    with _locked(root + ".lock"):
        if not os.path.exists(marker):
            log(f"building the database {root} ({params['entries']} "
                f"entries) ...")
            part = root + ".part"
            shutil.rmtree(part, ignore_errors=True)
            shutil.rmtree(root, ignore_errors=True)
            build(part, params, processes)
            os.rename(part, root)
            with open(marker, "w") as fh:
                fh.write(key + "\n")
    return _load(root)


def _train(args):
    seq, out_dir = args
    from benchmark.reference.gm.pipeline.train_all import train_genome

    train_genome(seq, NC, out_dir)


def _derive(args):
    """Write the derived entries ``ks``, each a perturbed copy of its
    trained genome's entry, with its own seeded stream."""
    gdir, ks, trained, sd, seed = args
    from benchmark.reference.gm.models.icm import read_icm, write_icm
    from benchmark.traffic.generators import perturb_icm

    src = {}
    for k in ks:
        g = k % trained
        if g not in src:
            base = os.path.join(gdir, f"t{g}", NC)
            src[g] = (base, read_icm(base + ".icm"), read_icm(base + ".gicm"))
        base, icm, gicm = src[g]
        out = os.path.join(gdir, entry_name(k, trained).split("|")[0])
        os.makedirs(out)
        rng = np.random.default_rng([seed, k])
        write_icm(perturb_icm(rng, icm, sd), os.path.join(out, NC + ".icm"))
        write_icm(perturb_icm(rng, gicm, sd), os.path.join(out, NC + ".gicm"))
        for suf in FEATURE_SUFFIXES:
            shutil.copyfile(base + suf, os.path.join(out, NC + suf))


def build(root, p, processes=None) -> None:
    """Build the database of parameters ``p`` into the new directory
    ``root``."""
    from benchmark.traffic.generators import synth_genome

    n, trained = p["entries"], p["trained_genomes"]
    rng = np.random.default_rng(p["database_seed"])
    gcs = np.linspace(p["gc_low"], p["gc_high"], trained)
    seqs = [synth_genome(rng, float(gc), p["genome_bp"]) for gc in gcs]
    neighbours = np.array([
        rng.choice(np.delete(np.arange(n), k), p["neighbours"],
                   replace=False) for k in range(n)], np.int64)
    gdir = os.path.join(root, "genomeData")
    os.makedirs(gdir)
    processes = processes or min(trained, os.cpu_count() or 1)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(processes) as pool:
        pool.map(_train, [(s, os.path.join(gdir, f"t{k}"))
                          for k, s in enumerate(seqs)])
        ks = list(range(trained, n))
        pool.map(_derive, [(gdir, ks[i::processes], trained,
                            p["perturb_sd"], p["database_seed"])
                           for i in range(processes)])
    with open(os.path.join(root, "genomes.txt"), "w") as fh:
        for s in seqs:
            fh.write(s.lower() + "\n")
    with open(os.path.join(root, "meta.json"), "w") as fh:
        json.dump({"params": p,
                   "entries": [entry_name(k, trained) for k in range(n)],
                   "genome_of": [k % trained for k in range(n)],
                   "neighbours": neighbours.tolist()}, fh)
