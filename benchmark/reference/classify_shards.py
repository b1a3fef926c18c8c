"""The shard edges of the read-sharded classify cells: the exact ICM walk
(``walk.Bank``) of the first and the last read of each rank's share of
every file kept, against the raw matrix and the results table as
written. A rank's share is the records whose ``>`` lies in its
contiguous byte range, ``[S*i//parts, S*(i+1)//parts)`` of a file of
``S`` bytes; a segment written at the wrong offset shows at its edges."""

from __future__ import annotations

import glob
import os
import time

import numpy as np
import torch

from .classify import _BASE, read_fasta, read_raw, read_table
from .walk import Bank


def edges(path, parts):
    """The record numbers of the first and last read of each non-empty
    share of the FASTA file ``path``."""
    size = os.path.getsize(path)
    starts, at = [], 0
    with open(path, "rb") as fh:
        for line in fh:
            if line.startswith(b">"):
                starts.append(at)
            at += len(line)
    starts = np.array(starts)
    out = set()
    for i in range(parts):
        mine = np.flatnonzero((starts >= size * i // parts)
                              & (starts < size * (i + 1) // parts))
        if mine.size:
            out |= {int(mine[0]), int(mine[-1])}
    return sorted(out)


def check(icm_dir, written, parts, device, log):
    """``shard_edge_gap``: over the edge reads of every file of
    ``written`` ((input FASTA, raw matrix, results table)), the widest gap
    between a score the files give (each ICM's raw score, the table's
    best) and the exact walk's; infinite where a read id is out of
    place."""
    t0 = time.perf_counter()
    paths = sorted(glob.glob(os.path.join(icm_dir, "*", "*.icm")))
    bank = Bank(paths, device)
    gap, n = 0.0, 0

    def worse(old, new):
        return new if not new <= old else old  # NaN is worst

    for src, raw, table in written:
        seqs = read_fasta(src)
        names = list(seqs)
        cols = edges(src, parts)
        _icms, ids, scores = read_raw(raw, cols)
        _head, rows = read_table(table)
        for k, j in enumerate(cols):
            if j >= len(ids) or ids[j] != names[j] or j >= len(rows) \
                    or rows[j][0] != names[j]:
                gap = float("inf")
                continue
            s = torch.tensor([_BASE[c] for c in seqs[names[j]].lower()],
                             dtype=torch.int64, device=device)
            want = bank.classify(s).cpu().numpy()
            gap = worse(gap, float(np.max(np.abs(scores[k] - want))))
            gap = worse(gap, abs(rows[j][2] - float(want.max())))
            n += 1
    log(f"reference: {n} shard edge reads of {len(written)} files in "
        f"{parts} shares in {time.perf_counter() - t0:.1f} s")
    return {"shard_edge_gap": gap}
