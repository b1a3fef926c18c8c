# Frozen copy of glimmer_mg_torch/pipeline/elph.py at commit ab5a5d3.
"""Motif finder producing ELPH-style count matrices (RBS model).

The reference pipeline runs the external ELPH Gibbs sampler over 25bp
upstream windows and converts its output to a 6-wide count matrix
(train_features.py:710, get-motif-counts.awk). ELPH itself is not part of
the reference repo and is stochastic (the manual warns results vary between
runs, docs/notes.tex:249-253); we implement a deterministic hard-EM motif
finder with a most-frequent-k-mer seed. The output format is identical:

    6
    a    1197    1252 ...
    c ...
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from ..models import dna

_BASES = "acgt"


def _encode_upper(seqs):
    return [dna.encode(s.lower()) for s in seqs]


def motif_counts(upstream_seqs, width: int = 6, iters: int = 50) -> str:
    """Find one motif occurrence per sequence; return the count matrix text.

    With no usable input, emits the all-ones matrix exactly like
    train_features.py:715-722.
    """
    seqs = [s for s in upstream_seqs if len(s) >= width]
    if not seqs:
        cols = tuple([1] * width)
        lines = [str(width)]
        for b in _BASES:
            lines.append(b + " " + " ".join("%7d" % c for c in cols))
        return "\n".join(lines) + "\n"

    enc = _encode_upper(seqs)

    # deterministic seed: the most frequent width-mer (ties: lexic. smallest)
    kmer_counts: Counter = Counter()
    for e in enc:
        for i in range(len(e) - width + 1):
            kmer_counts[tuple(e[i : i + width])] += 1
    seed = min(kmer_counts, key=lambda k: (-kmer_counts[k], k))

    # init counts from the seed with pseudocounts
    counts = np.ones((width, 4), dtype=np.float64)
    for j, b in enumerate(seed):
        counts[j, b] += len(seqs)

    offsets = None
    for _ in range(iters):
        # M: log-odds vs uniform background
        probs = counts / counts.sum(axis=1, keepdims=True)
        lo = np.log(probs) - np.log(0.25)
        # E (hard): best offset per sequence
        new_offsets = []
        for e in enc:
            n_off = len(e) - width + 1
            scores = [lo[np.arange(width), e[i : i + width]].sum() for i in range(n_off)]
            new_offsets.append(int(np.argmax(scores)))
        if new_offsets == offsets:
            break
        offsets = new_offsets
        counts = np.full((width, 4), 1e-3)
        for e, off in zip(enc, offsets):
            counts[np.arange(width), e[off : off + width]] += 1

    final = np.zeros((width, 4), dtype=np.int64)
    for e, off in zip(enc, offsets):
        final[np.arange(width), e[off : off + width]] += 1

    lines = [str(width)]
    for bi, b in enumerate(_BASES):
        lines.append(b + " " + " ".join("%7d" % final[j, bi] for j in range(width)))
    return "\n".join(lines) + "\n"
