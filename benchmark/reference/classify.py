"""The plain reference of the classify cells: the exact ICM walk of every
genome ICM (``walk.Bank``, reading the ICM files itself) over a seeded
sample of the reads of each file the program wrote, and the comparison
with the raw matrix and the results table as written."""

from __future__ import annotations

import glob
import os
import time

import numpy as np
import torch

from .walk import Bank

_BASE = {c: i for i, c in enumerate("acgt")}


def read_fasta(path):
    """{header's first word: sequence} of a FASTA file."""
    out, name, parts = {}, None, []
    with open(path) as fh:
        for line in fh:
            if line.startswith(">"):
                if name is not None:
                    out[name] = "".join(parts)
                name, parts = line[1:].split()[0], []
            else:
                parts.append(line.strip())
    if name is not None:
        out[name] = "".join(parts)
    return out


def read_raw(path, cols):
    """(ICM list, read ids, (len(cols), models) scores of the reads at
    ``cols``) of a raw Phymm matrix as written."""
    with open(path) as fh:
        lines = fh.read().split("\n")
    a = lines.index("BEGIN_ICM_LIST")
    b = lines.index("END_ICM_LIST")
    c = lines.index("BEGIN_READID_LIST")
    d = lines.index("END_READID_LIST")
    e = lines.index("BEGIN_DATA_MATRIX")
    f = lines.index("END_DATA_MATRIX")
    icms, ids = lines[a + 1:b], lines[c + 1:d]
    rows = lines[e + 1:f]
    scores = np.full((len(cols), len(rows)), np.nan)
    for g, row in enumerate(rows):
        vals = row.split(" ")
        if len(vals) != len(ids):
            continue  # a short row leaves NaN, which fails the check
        scores[:, g] = [float(vals[j]) for j in cols]
    return icms, ids, scores


def read_table(path):
    """[(query id, best match, score)] of a results table."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    out = []
    for line in lines[1:]:
        t = line.split("\t")
        out.append((t[0], t[1], float(t[2])))
    return lines[0], out


def check(icm_dir, written, lengths, per_file, rng, device, log):
    """Numbers of the written files (``written``: (input FASTA, raw
    matrix, results table)): ``ids_wrong`` read ids, ICM paths and table
    rows out of place; ``raw_gap`` the widest gap between a raw score and
    the exact walk's; ``table_gap`` between a table's score and the exact
    best; ``best_gap`` how far the exact walk puts the genome the table
    names below the exact best."""
    t0 = time.perf_counter()
    paths = sorted(glob.glob(os.path.join(icm_dir, "*", "*.icm")))
    bank = Bank(paths, device)
    strains = [p.split("/")[-2] for p in paths]
    longest = max(lengths, key=lambda h: lengths[h])
    ids_wrong, raw_gap, table_gap, best_gap, n = 0, 0.0, 0.0, 0.0, 0

    def worse(old, new):
        return new if not new <= old else old  # NaN is worst

    for src, raw, table in written:
        seqs = read_fasta(src)
        names = list(seqs)
        cols = sorted(set(rng.choice(len(names), size=min(per_file,
                                                          len(names)),
                                     replace=False).tolist()))
        if longest in seqs:
            cols = sorted(set(cols) | {names.index(longest)})
        icms, ids, scores = read_raw(raw, cols)
        ids_wrong += (icms != paths) + sum(
            a != b for a, b in zip(ids, names)) + abs(len(ids) - len(names))
        head, rows = read_table(table)
        ids_wrong += abs(len(rows) - len(names)) + (not head.startswith(
            "QUERY_ID\tBEST_MATCH\tSCORE"))
        for k, j in enumerate(cols):
            s = torch.tensor([_BASE[c] for c in seqs[names[j]].lower()],
                             dtype=torch.int64, device=device)
            want = bank.classify(s).cpu().numpy()
            raw_gap = worse(raw_gap, float(np.max(np.abs(scores[k] - want))))
            if j < len(rows):
                rid, best, score = rows[j]
                ids_wrong += rid != names[j]
                table_gap = worse(table_gap, abs(score - float(want.max())))
                at = [g for g, st in enumerate(strains) if st == best]
                got = max(want[g] for g in at) if at else -np.inf
                best_gap = worse(best_gap, float(want.max() - got))
            n += 1
    log(f"reference: {n} reads of {len(written)} files against "
        f"{len(paths)} ICMs in {time.perf_counter() - t0:.1f} s")
    return {"ids_wrong": ids_wrong, "raw_gap": raw_gap,
            "table_gap": table_gap, "best_gap": best_gap}
