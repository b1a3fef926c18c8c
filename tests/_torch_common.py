"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_*.py).

Everything is made from numpy seeds: two synthetic genomes trained into a
genomeData directory with ``train_all`` (the JAX package's own fixture
pattern), and read sets of three kinds (random, overlap-dense, long).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import pytest


@pytest.fixture(scope="module")
def trained_models():
    """A two-genome model database (GC 0.38 / 0.58) and its class names."""
    from glimmer_mg_tpu.io.genome_data import GenomeData
    from glimmer_mg_tpu.pipeline import train_all

    rng = np.random.default_rng(5)
    root = tempfile.mkdtemp(prefix="torch_db_")
    genomes = {}
    for gi, gc in ((0, 0.38), (1, 0.58)):
        p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]

        def gene(ncod):
            cs = []
            while len(cs) < ncod:
                c = "".join(rng.choice(list("ACGT"), 3, p=p))
                if c not in ("TAA", "TAG", "TGA"):
                    cs.append(c)
            return "ATG" + "".join(cs) + rng.choice(["TAA", "TAG", "TGA"])

        parts = []
        for _ in range(60):
            parts.append(
                "".join(rng.choice(list("ACGT"), int(rng.integers(40, 200)),
                                   p=p)))
            g = gene(int(rng.integers(80, 300)))
            if rng.random() < 0.5:
                g = g[::-1].translate(str.maketrans("ACGT", "TGCA"))
            parts.append(g)
        genomes[f"s{gi}|chr"] = "".join(parts)
    train_all.train_all(genomes, os.path.join(root, "genomeData"))
    gd = GenomeData(os.path.join(root, "genomeData"))
    return gd, list(genomes)


def _gene_like(rng, ncod, gc):
    p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
    cs = []
    while len(cs) < ncod:
        c = "".join(rng.choice(list("acgt"), 3, p=p))
        if c not in ("taa", "tag", "tga"):
            cs.append(c)
    return "atg" + "".join(cs) + str(rng.choice(["taa", "tag", "tga"]))


def random_reads(seed, count, lo=30, hi=700):
    """Random reads of varied length and GC, degenerate tiny ones included."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(count):
        n = int(rng.integers(lo, hi))
        gc = float(rng.uniform(0.3, 0.7))
        p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
        reads.append((f"fz{i}", "".join(rng.choice(list("acgt"), n, p=p))))
    return reads


def overlap_dense_reads(seed, count, length=500):
    """Tightly packed, overlapping gene-like segments on both strands."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(count):
        gc = (0.38, 0.58)[i % 2]
        parts = []
        total = 0
        while total < length - 50:
            g = _gene_like(rng, int(rng.integers(30, 80)), gc)
            if rng.random() < 0.5:
                g = g[::-1].translate(str.maketrans("acgt", "tgca"))
            ov = int(rng.integers(0, 45))
            if parts and ov:
                joined = "".join(parts)
                parts = [joined[: max(0, len(joined) - ov)]]
            parts.append(g)
            total = sum(len(p) for p in parts)
        reads.append((f"ov{i}", "".join(parts)[:length]))
    return reads


def long_reads(seed, count, lo=1450, hi=2100):
    """Gene-dense reads longer than 1.4 kb."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(count):
        gc = (0.38, 0.58)[i % 2]
        parts = []
        total = 0
        target = int(rng.integers(lo, hi))
        while total < target:
            parts.append("".join(
                rng.choice(list("acgt"), int(rng.integers(20, 80)))))
            g = _gene_like(rng, int(rng.integers(40, 150)), gc)
            if rng.random() < 0.5:
                g = g[::-1].translate(str.maketrans("acgt", "tgca"))
            parts.append(g)
            total = sum(len(x) for x in parts)
        reads.append((f"lr{i}", "".join(parts)[:target]))
    return reads


def class_map(reads, classes, pair_every=0):
    """Each read classified to one class (alternating); with pair_every=k,
    every k-th read also to the other class."""
    out = {}
    for i, (h, _s) in enumerate(reads):
        cl = [classes[i % 2]]
        if pair_every and i % pair_every == 0:
            cl.append(classes[(i + 1) % 2])
        out[h.split()[0]] = cl
    return out


def batch_inputs(reads, cmap, gd, l_pad, b_pad):
    """A padded device batch in input order: (models_list, reads (b_pad,
    l_pad) i32, lengths, groups), with per-read classes-mode Models."""
    from glimmer_mg_tpu.models import dna
    from glimmer_mg_torch.engine import glimmer_mg as teng

    cache, ids, models_list = {}, {}, []
    out_reads = np.zeros((b_pad, l_pad), np.int32)
    lengths = np.zeros(b_pad, np.int32)
    groups = np.zeros(b_pad, np.int32)
    for r, (h, s) in enumerate(reads):
        key = (tuple(cmap[h]), len(s))
        m = cache.get(key)
        if m is None:
            m = cache[key] = teng.classes_models(
                list(key[0]), len(s), gd, parsed=None, user_icm=None,
                user_gc=None, user_rbs_pwm=None, user_stop_codons=None,
                fudge_f32=np.float32(1.0), min_gene_len=75,
                max_olap_bases=50, circular=False, icm_cache={})
        if id(m) not in ids:
            ids[id(m)] = len(models_list)
            models_list.append(m)
        out_reads[r, :len(s)] = dna.encode(s)
        lengths[r] = len(s)
        groups[r] = ids[id(m)]
    return models_list, out_reads, lengths, groups


def coords(genes):
    return [(g.id, g.start, g.stop, g.frame) for g in genes]


# wrapper arguments with one out of range (bad_bank_walk_call cases)
BAD = ["depth_too_deep", "length_not_multiple_of_3", "length_past_L",
       "length_negative", "prob_rows_short", "model_len_too_long"]


def bad_bank_walk_call(t, case):
    """bank_score_reads_kernel arguments (list, kwargs) with one out of
    range; ``t`` = [level_mip, probs_pk, reads, lengths]."""
    t, kw = list(t), {"model_len": 12, "depth": 7}
    if case == "depth_too_deep":
        kw["depth"] = 8
    elif case == "length_not_multiple_of_3":
        t[2] = t[2][:, :-1].contiguous()
        t[3] = t[3].clamp(max=t[2].shape[1])
    elif case == "length_past_L":
        t[3] = t[3].clone()
        t[3][1] = t[2].shape[1] + 1
    elif case == "length_negative":
        t[3] = t[3].clone()
        t[3][0] = -1
    elif case == "prob_rows_short":
        t[1] = t[1][:, :, :-2].contiguous()
    else:
        kw["model_len"] = 17
    return t, kw
