# Copies of chip_smoke.py's generators at commit ab5a5d3: synth_genome,
# the perturbation of add_decoys (as perturb_icm), with_substitutions and
# with_homopolymer_indels, with their imports moved to the top.
"""Seeded generators of genomes, ICM copies and read errors."""

from __future__ import annotations

import dataclasses

import numpy as np


def synth_genome(rng, gc, size):
    """Gene-dense synthetic genome: GC-weighted sense codons between
    ATG and a stop, on both strands, separated by GC-weighted spacers."""
    base_p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    codons = [a + b + c for a in "ACGT" for b in "ACGT" for c in "ACGT"]
    sense = [c for c in codons if c not in ("TAA", "TAG", "TGA")]
    w = np.array([np.prod([base_p["ACGT".index(ch)] for ch in c])
                  for c in sense])
    w /= w.sum()
    comp = str.maketrans("ACGT", "TGCA")
    parts, total = [], 0
    while total < size:
        spacer = "".join(rng.choice(list("ACGT"), int(rng.integers(30, 250)),
                                    p=base_p))
        body = "".join(np.asarray(sense)[rng.choice(
            len(sense), int(rng.integers(100, 500)), p=w)])
        gene = "ATG" + body + str(rng.choice(["TAA", "TAG", "TGA"]))
        if rng.random() < 0.5:
            gene = gene[::-1].translate(comp)
        parts += [spacer, gene]
        total += len(spacer) + len(gene)
    return "".join(parts)[:size]


def perturb_icm(rng, src, sd):
    """A seeded perturbed copy of the ICM ``src``: log-probs x (1 + sd
    N(0,1)), the same tree, so it costs what a real ICM costs to load
    and walk (add_decoys at sd 0.01)."""
    noise = 1.0 + sd * rng.standard_normal(src.probs.shape)
    return dataclasses.replace(src, mip=src.mip.copy(),
                               probs=(src.probs * noise).astype("float32"))


def with_substitutions(reads, rate, seed):
    """Each base replaced by another at ``rate``; Phred 2-41 qualities for
    two reads in three. Returns (reads, qualities by header)."""
    rng = np.random.default_rng(seed)
    out, quals = [], {}
    for i, (h, s) in enumerate(reads):
        seq = np.frombuffer(s.encode(), dtype=np.uint8).copy()
        hit = rng.random(len(seq)) < rate
        shift = rng.integers(1, 4, len(seq))
        idx = np.searchsorted(np.frombuffer(b"acgt", np.uint8), seq)
        seq[hit] = np.frombuffer(b"acgt", np.uint8)[(idx + shift)[hit] % 4]
        out.append((h, seq.tobytes().decode()))
        if i % 3 != 2:
            quals[h] = rng.integers(2, 42, len(seq)).tolist()
    return out, quals


def with_homopolymer_indels(reads, rate, seed):
    """454-like errors: inside homopolymer runs (about a quarter of the
    bases) a base is dropped or repeated at 4 x ``rate``, so ``rate`` per
    base over a read."""
    rng = np.random.default_rng(seed)
    out = []
    for h, s in reads:
        u = rng.random(len(s))
        parts = []
        for k, ch in enumerate(s):
            r = u[k] if k and s[k - 1] == ch else 1.0
            if r >= 2 * rate:
                parts.append(ch + ch if r < 4 * rate else ch)
        out.append((h, "".join(parts)))
    return out
