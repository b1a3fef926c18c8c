"""Bytes each kernel launch must move: each input byte read once and
each output byte written once, counted below each read's length (reads,
K1's scores, event rows below each read's event count, genes below its
gene count), never the padding.

KF's and K3's counts follow chip_smoke.py's ``kf_bytes`` and ``k3_bytes``
at commit ab5a5d3, tightened to the rows each read really has; K2's
follows chip_smoke.py's bank-walk bound (all the bank's tables, which a
batch's walks cover); K1's counts the table entries its walks read; KT's,
the raw-text kernels', follows chip_smoke.py's raw-text bound (the scores
in, the text out).

A launch's record is taken while the window runs and holds no value that
needs a device sync; ``resolve`` finishes it after the window.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.walk import pack_contexts, read_variants, walk

# KF reads these of the bank's tables (chip_smoke.py kf_bytes)
KF_TABLES = ("fwd_start rev_start fwd_stop rev_stop which_fwd which_rev "
             "prior start_lo len_score ignore_score_len pwm_cols pwm_n "
             "pwm_user pwm_is_user gc_lp").split()
K3_TABLES = ("adj_or", "adj_dist", "adj_dist_len")
MAX_GENES = 48


def _sum(t):
    return t.to(torch.int64).sum()


def kf_record(seq, n, gi, g6, i6, bank, Lp, ev, n_events, quals):
    """KF: the reads' bases, lengths and groups, K1's two six-frame
    tables below each read's length, the bank tables it reads, the
    qualities and their probability table in substitution mode; out, the
    event rows below each read's count and the counts."""
    E = ev["pos"].shape[1]
    fixed = n.nbytes + gi.nbytes + sum(bank[k].nbytes for k in KF_TABLES)
    fixed += n_events.nbytes
    per_base = seq.element_size() + 2 * 6 * g6.element_size()
    if quals is not None:
        per_base += quals.element_size()
        fixed += 256 * 8
    per_row = sum(t.element_size() for t in ev.values())
    return {"fixed": fixed,
            "terms": [(per_base, _sum(n.clamp(0, Lp))),
                      (per_row, _sum(n_events.clamp(0, E)))]}


def k3_record(ev, tables, groups, ne, outs):
    """K3: the event rows below each read's count, the counts and groups,
    the adjacency tables; out, the DP's score and back-pointer rows below
    the count, a read's best, window flag and gene count, and its
    genes."""
    sb = ev["score"].element_size()
    B = groups.shape[0]
    row = 4 * 4 + sb + 1 + (8 if "err_pos" in ev else 0)
    fixed = (ne.nbytes + groups.nbytes
             + sum(tables[k].nbytes for k in K3_TABLES)
             + B * (6 * 4 + 1 + 4))
    cnt = outs[-1]
    return {"fixed": fixed,
            "terms": [(row + sb + 4, _sum(ne)),
                      (6 * 4 + 1 + sb, _sum(cnt.clamp(0, MAX_GENES)))]}


def k2_record(level_mip, probs_pk, reads, lengths, out):
    """K2: the bank's tables, the reads' bases below each length and the
    lengths; out, the score matrix."""
    fixed = (level_mip.nbytes + probs_pk.nbytes + lengths.nbytes
             + out.nbytes)
    return {"fixed": fixed,
            "terms": [(reads.element_size(), _sum(lengths))]}


def kt_record(scores, text):
    """KT: the float32 score matrix in; out, the text of its rows (the
    kernels' scratch of widths and offsets is neither)."""
    return {"fixed": scores.numel() * scores.element_size() + len(text),
            "terms": []}


def k1_record(reads, lengths, group, models, model_len, depth):
    """K1: the reads' bases below each length, lengths and groups; the
    entries of each group's gene and null ICM tables that its walks read
    (a mut_info_pos at every node a walk enters, a prob at every node it
    ends on, each counted once); out, two (6, L) score tables below each
    read's length. The table entries are counted in ``resolve``."""
    live = _sum(lengths)
    return {"fixed": lengths.nbytes + group.nbytes,
            "terms": [(reads.element_size() + 2 * 6 * 4, live)],
            "k1": (reads, lengths, group, models, model_len, depth)}


def _distinct_entries(reads, lengths, group, icms, model_len, depth):
    """(mip entries, prob entries) of the groups' tables that six-frame
    walks over both read variants read, each counted once; ``icms`` the
    ICM of each group."""
    dev = reads.device
    uniq, index = {}, []
    for m in icms:
        index.append(uniq.setdefault(id(m), (len(uniq), m))[0])
    tabs = sorted(uniq.values(), key=lambda t: t[0])
    p = tabs[0][1].periodicity
    n = max(m.mip.shape[1] for _k, m in tabs)
    mip = np.full((len(tabs), p, n), -1, np.int64)
    for k, m in tabs:
        mip[k, :, :m.mip.shape[1]] = m.mip
    mip = torch.from_numpy(mip.reshape(-1)).to(dev)
    index = torch.tensor(index, dtype=torch.int64, device=dev)

    live = (torch.arange(reads.shape[1], device=dev)[None, :]
            < lengths.to(torch.int64)[:, None])
    g = group.to(torch.int64)[:, None].expand(live.shape)[live]
    i = torch.arange(reads.shape[1], device=dev)[None, :].expand(
        live.shape)[live]
    thresh = (model_len - 1 - i).clamp(min=0)
    mip_keys, prob_keys = [], []
    for seq in read_variants(reads, lengths):
        ctx = pack_contexts(seq, model_len)[live]
        base = seq[live]
        for f in range(3):
            lookup = (index[g] * p + f % p) * n  # where the values are
            key = (g * p + f % p) * n            # which group's entry

            def visit(node):
                mip_keys.append(torch.unique(key + node))

            final = walk(mip, lookup, ctx, thresh, depth, visit)
            prob_keys.append(torch.unique((key + final) * 4 + base))
    return (torch.unique(torch.cat(mip_keys)).numel(),
            torch.unique(torch.cat(prob_keys)).numel())


def resolve(rec) -> int:
    """The bytes of one launch record."""
    total = rec["fixed"] + sum(per * int(t) for per, t in rec["terms"])
    if "k1" in rec:
        reads, lengths, group, models, model_len, depth = rec["k1"]
        for icms, ml, d in (([m.gene_icm for m in models], model_len, depth),
                            ([m.indep_model for m in models], 3, 2)):
            n_mip, n_prob = _distinct_entries(reads, lengths, group, icms,
                                              ml, d)
            total += n_mip * icms[0].mip.itemsize + n_prob * 4
    return total
