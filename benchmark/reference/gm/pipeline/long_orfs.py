# Frozen copy of glimmer_mg_torch/pipeline/long_orfs.py at commit ab5a5d3.
"""long-orfs: bootstrap training-set finder.

Reference: src/Glimmer/long-orfs.cc. Finds maximal ORFs (circular by
default), optionally filters by amino-acid entropy distance, auto-optimizes
the minimum gene length to maximize the count (or total bp) of
non-overlapping ORFs, eliminates overlaps, and emits the coordinate list
used by `extract` to build the ICM training set.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from ..models import dna, translate
from ..engine.orfs import CodonPatterns

INT_MAX = 2**31 - 1
DEFAULT_MIN_GENE_LEN = 90
DEFAULT_MAX_OLAP = 30


@dataclasses.dataclass
class Interval:
    lo: int  # 0-based between coords of the coding part (no stop codon)
    hi: int
    frame: int
    deleted: bool = False


def _scan_arrays(seq_idx: np.ndarray, pat: CodonPatterns, circular: bool):
    """Boolean codon-class arrays over the (possibly extended) sequence, plus
    doubled-sequence variants for wraparound walks."""
    masks = np.array([1, 2, 4, 8], dtype=np.uint8)[seq_idx]
    n = len(seq_idx)
    ext = np.concatenate([masks, masks[:2]]) if circular else masks
    cod = dna.codon12_stream(ext)
    fwd_start = dna.can_be(cod, pat.fwd_start)
    rev_start = dna.can_be(cod, pat.rev_start)
    fwd_stop = dna.must_be(cod, pat.fwd_stop)
    rev_stop = dna.must_be(cod, pat.rev_stop)
    dbl = dna.codon12_stream(np.concatenate([masks, masks]))
    return ext, fwd_start, rev_start, fwd_stop, rev_stop, dbl


def _wrap_through_front(n, pos, dbl_cod, pat):
    """long-orfs.cc:1550 Wrap_Through_Front."""
    s = (pos - 1) % 3
    check_len = n + s - pos - 4
    start_at = -1
    i = 0
    while i < check_len:
        # codon first base at 0-based s-3 (wrapped); last base index in the
        # doubled stream = (s - 1) % n + n for wrapped access
        first = s - 3
        last = first + 2
        j = last % n + n  # always index the second copy
        cod = dbl_cod[j]
        if dna.must_be(np.array([cod]), pat.fwd_stop)[0]:
            break
        if dna.can_be(np.array([cod]), pat.fwd_start)[0]:
            start_at = i + 3
        s = first
        i += 3
    orf_len = i + 3 * ((pos - 1) // 3)
    gene_len = 0 if start_at == -1 else start_at + 3 * ((pos - 1) // 3)
    return gene_len, orf_len


def _wrap_around_back(n, wfr, pos, dbl_cod, pat):
    """long-orfs.cc:1486 Wrap_Around_Back."""
    check_len = pos - 1
    start_at = -1
    orf_add = 0
    # only loop indices i with i % 3 == wfr matter; codon ends at i
    i = wfr
    while i < check_len:
        cod = dbl_cod[i] if i >= 2 else 0
        if i >= 2 and dna.must_be(np.array([cod]), pat.rev_stop)[0]:
            orf_add = i - 2
            break
        orf_add = i + 1
        if i >= 2 and dna.can_be(np.array([cod]), pat.rev_start)[0]:
            start_at = i + 1
        i += 3
    orf_len = orf_add + n - pos - 2
    orf_len -= orf_len % 3
    gene_len = 0 if start_at == -1 else start_at + n - pos - 2
    return gene_len, orf_len


def find_long_orfs(
    seq_idx: np.ndarray,
    pat: CodonPatterns,
    min_gene_len: int,
    circular: bool = True,
    ignore_regions: list[tuple[int, int]] | None = None,
):
    """long-orfs.cc:570 Find_Orfs: (stop_position, frame, gene_len) list."""
    n = len(seq_idx)
    orfs = []
    if n < min_gene_len:
        return orfs
    ext, fwd_start, rev_start, fwd_stop, rev_stop, dbl = _scan_arrays(
        seq_idx, pat, circular
    )
    n_ext = len(ext)
    idx = np.arange(n_ext)
    det_ok = np.ones(n_ext, dtype=bool)
    if ignore_regions:
        # no codon detections while ignoring nor until the codon register
        # refills: Codon_t::Clear at region end (long-orfs.cc:665).
        for lo, hi in ignore_regions:
            det_ok[lo : min(hi + 2, n_ext)] = False
    fstarts = [idx[fwd_start & det_ok & (idx % 3 == f)].tolist() for f in range(3)]
    rstarts = [idx[rev_start & det_ok & (idx % 3 == f)].tolist() for f in range(3)]
    stop_events = sorted(
        [(int(i), +1) for i in idx[fwd_stop & det_ok]]
        + [(int(i), -1) for i in idx[rev_stop & det_ok]]
        + [(lo, 0) for lo, _ in (ignore_regions or [])]
        + [(hi, 2) for _, hi in (ignore_regions or [])]
    )

    import bisect

    prev_fwd_stop = [0, 0, 0]
    prev_rev_stop = [0, 0, 0]
    first_base = 1  # first position of the current post-ignore segment
    segment_bound = -1  # loop indices <= this hold no usable starts
    hit_ignore = False

    def first_fwd_start_after(f, prev_i, before_i):
        lst = fstarts[f]
        k = bisect.bisect_right(lst, max(prev_i, segment_bound))
        if k < len(lst) and lst[k] < before_i:
            return lst[k] - 1
        return INT_MAX

    def last_rev_start_between(f, after_i, before_i):
        lst = rstarts[f]
        k = bisect.bisect_left(lst, before_i)
        if k > 0 and lst[k - 1] > max(after_i, segment_bound):
            return lst[k - 1] - 1
        return 0

    def finish_rev_linear(last_position):
        """Finish_Orfs(false,...) at an ignore-region start
        (long-orfs.cc:637, Handle_Last_Reverse_Stop non-wrap branch)."""
        for f in range(3):
            if prev_rev_stop[f] == 0:
                continue
            last_start = last_rev_start_between(
                f, prev_rev_stop[f] + 1, last_position
            )
            gene_len = 0 if last_start == 0 else last_start - prev_rev_stop[f]
            if gene_len >= min_gene_len:
                orfs.append((prev_rev_stop[f], -1 - (f + 1) % 3, gene_len))

    for i0, strand in stop_events:
        i = i0  # reference loop subscript (0-based last base of codon)
        f = i0 % 3
        pos = i - 1  # 1-based first base of the stop codon
        if strand == 0:  # ignore-region start (long-orfs.cc:636)
            finish_rev_linear(i0)
            hit_ignore = True
        elif strand == 2:  # ignore-region end: reset registers (:641-662)
            for g in range(3):
                prev_fwd_stop[g] = 0
                prev_rev_stop[g] = 0
            first_base = i0 + 1
            segment_bound = i0 + 1
        elif strand > 0:
            start_pos = first_fwd_start_after(f, prev_fwd_stop[f] + 1, i)
            if prev_fwd_stop[f] == 0:
                if circular and not hit_ignore:
                    gene_len, orf_len = _wrap_through_front(n, pos, dbl, pat)
                    if gene_len == 0 and start_pos != INT_MAX:
                        gene_len = pos - start_pos
                else:
                    orf_len = pos - first_base
                    orf_len -= orf_len % 3
                    gene_len = 0 if start_pos == INT_MAX else pos - start_pos
            else:
                gene_len = 0 if start_pos == INT_MAX else pos - start_pos
                orf_len = pos - prev_fwd_stop[f] - 3
            if gene_len >= min_gene_len:
                orfs.append((pos, 1 + (f + 1) % 3, gene_len))
            prev_fwd_stop[f] = pos
        else:
            if prev_rev_stop[f] != 0:
                last_start = last_rev_start_between(f, prev_rev_stop[f] + 1, i)
                gene_len = last_start - prev_rev_stop[f]
                if gene_len >= min_gene_len:
                    orfs.append((prev_rev_stop[f], -1 - (f + 1) % 3, gene_len))
            prev_rev_stop[f] = pos

    # Finish_Orfs (long-orfs.cc:744). NOTE the reference passes
    # Genome_Is_Circular here even after hitting an ignore region
    # (long-orfs.cc:733), unlike glimmer3's Finish_Orfs call.
    for f in range(3):
        if prev_rev_stop[f] == 0:
            continue
        if circular:
            wfr = (3 + f - (n % 3)) % 3
            gene_len, orf_len = _wrap_around_back(n, wfr, prev_rev_stop[f], dbl, pat)
            if gene_len == 0:
                last_start = last_rev_start_between(f, prev_rev_stop[f] + 1, n_ext + 1)
                if last_start > 0:
                    gene_len = last_start - prev_rev_stop[f]
        else:
            last_start = last_rev_start_between(f, prev_rev_stop[f] + 1, n + 1)
            gene_len = 0 if last_start == 0 else last_start - prev_rev_stop[f]
        if gene_len >= min_gene_len:
            orfs.append((prev_rev_stop[f], -1 - (f + 1) % 3, gene_len))

    return orfs


def get_intervals(orfs, n):
    """long-orfs.cc:876: 0-based between coords of the coding part, sorted."""

    def on_seq_0(i):
        while i < 0:
            i += n
        while i >= n:
            i -= n
        return i

    ivs = []
    for stop, frame, gene_len in orfs:
        if frame > 0:
            hi = on_seq_0(stop - 1)
            lo = hi - gene_len
        else:
            lo = on_seq_0(stop + 2)
            hi = lo + gene_len
        ivs.append(Interval(lo, hi, frame))
    ivs.sort(key=lambda v: (v.lo, v.hi))
    return ivs


def _intersect_size(a_lo, a_hi, b_lo, b_hi):
    return min(a_hi, b_hi) - max(a_lo, b_lo)


def find_optimal_len(ivs, n, min_gene_len, max_olap, circular, optimize_total):
    """long-orfs.cc:393 Find_Optimal_Len."""
    m = len(ivs)
    if m == 0:
        return min_gene_len
    highest = [0] * m
    left_wrap = -ivs[0].lo if circular and ivs[0].lo < 0 else 0
    right_wrap = 0
    for i in range(m):
        highest[i] = ivs[i].hi if i == 0 else max(highest[i - 1], ivs[i].hi)
        if circular:
            right_wrap = max(right_wrap, ivs[i].hi - n)

    ranges = []
    for i in range(m):
        longest = min_gene_len - 1
        for j in range(i - 1, -1, -1):
            if highest[j] <= ivs[i].lo + max_olap:
                break
            if max_olap < _intersect_size(ivs[j].lo, ivs[j].hi, ivs[i].lo, ivs[i].hi):
                longest = max(longest, ivs[j].hi - ivs[j].lo)
        if circular and ivs[i].lo + max_olap <= right_wrap:
            j = m - 1
            while j > i and ivs[i].lo + max_olap <= highest[j] - n:
                if max_olap < _intersect_size(
                    ivs[i].lo, ivs[i].hi, ivs[j].lo - n, ivs[j].hi - n
                ):
                    longest = max(longest, ivs[j].hi - ivs[j].lo)
                j -= 1
        for j in range(i + 1, m):
            if ivs[i].hi <= ivs[j].lo + max_olap:
                break
            if max_olap < _intersect_size(ivs[j].lo, ivs[j].hi, ivs[i].lo, ivs[i].hi):
                longest = max(longest, ivs[j].hi - ivs[j].lo)
        if circular and n - ivs[i].hi + max_olap <= left_wrap:
            j = 0
            while j < i and n + ivs[j].lo <= ivs[i].hi - max_olap:
                if max_olap < _intersect_size(
                    ivs[i].lo, ivs[i].hi, ivs[j].lo + n, ivs[j].hi + n
                ):
                    longest = max(longest, ivs[j].hi - ivs[j].lo)
                j += 1
        i_len = ivs[i].hi - ivs[i].lo
        if longest < i_len:
            ranges.append((longest + 1, i_len))

    ranges.sort(key=lambda r: r[0])
    if not ranges:
        return min_gene_len
    pq: list[int] = []
    total_bases = count = 0
    opt_total_bases = opt_bases_len = 0
    opt_count = opt_count_len = 0
    for lo, hi in ranges:
        total_bases += hi
        count += 1
        while pq and pq[0] < lo:
            total_bases -= heapq.heappop(pq)
            count -= 1
        if opt_total_bases < total_bases or (
            opt_total_bases == total_bases and opt_count < count
        ):
            opt_total_bases = total_bases
            opt_bases_len = lo
        if opt_count < count or (opt_count == count and opt_total_bases < total_bases):
            opt_count = count
            opt_count_len = lo
        heapq.heappush(pq, hi)
    best = opt_bases_len if optimize_total else opt_count_len
    return max(best, min_gene_len)


def eliminate_overlapping(ivs, n, max_olap, circular):
    """long-orfs.cc:232."""
    m = len(ivs)
    if m == 0:
        return ivs
    highest = [0] * m
    right_wrap = 0
    for i in range(m):
        highest[i] = ivs[i].hi if i == 0 else max(highest[i - 1], ivs[i].hi)
        if circular:
            right_wrap = max(right_wrap, ivs[i].hi - n)
    for i in range(1, m):
        for j in range(i - 1, -1, -1):
            if highest[j] <= ivs[i].lo + max_olap:
                break
            if max_olap < _intersect_size(ivs[j].lo, ivs[j].hi, ivs[i].lo, ivs[i].hi):
                ivs[j].deleted = ivs[i].deleted = True
        if circular and ivs[i].lo + max_olap <= right_wrap:
            j = m - 1
            while j > i and ivs[i].lo + max_olap <= highest[j] - n:
                if max_olap < _intersect_size(
                    ivs[i].lo, ivs[i].hi, ivs[j].lo - n, ivs[j].hi - n
                ):
                    ivs[j].deleted = ivs[i].deleted = True
                j -= 1
    return [v for v in ivs if not v.deleted]


def read_entropy_profiles(path):
    """long-orfs.cc:1407 Read_Entropy_Profiles: header line then 20 rows of
    `name pos neg`; returns (pos_profile, neg_profile) arrays."""
    with open(path) as fh:
        lines = [ln.split() for ln in fh.read().splitlines()[1:] if ln.split()]
    pos = np.array([float(t[1]) for t in lines[:20]])
    neg = np.array([float(t[2]) for t in lines[:20]])
    if len(pos) != 20:
        raise ValueError(f"bad entropy profile file {path}")
    return pos, neg


def run_long_orfs(
    seq: str,
    *,
    min_gene_len: int = DEFAULT_MIN_GENE_LEN,
    max_olap: int = DEFAULT_MAX_OLAP,
    circular: bool = True,
    fixed_min_len: bool = False,
    optimize_total: bool = False,
    entropy_cutoff: float | None = None,
    start_codons=None,
    stop_codons=None,
    xlate_code: int = 0,
    ignore_regions: list[tuple[int, int]] | None = None,
    without_stops: bool = False,
    entropy_profiles: tuple[np.ndarray, np.ndarray] | None = None,
):
    """Returns (lines, final_min_len): formatted output rows + chosen length."""
    pat = CodonPatterns.make(start_codons, stop_codons)
    seq_idx = dna.encode(seq)
    n = len(seq_idx)
    orfs = find_long_orfs(seq_idx, pat, min_gene_len, circular, ignore_regions)

    def on_seq_1(i):
        while i < 1:
            i += n
        while i > n:
            i -= n
        return i

    def entropy_of(start, length, frame):
        s0 = on_seq_1(start) - 1
        if frame > 0:
            idxs = (s0 + np.arange(length)) % n
            buff = seq_idx[idxs]
        else:
            idxs = (s0 - np.arange(length)) % n
            buff = dna.COMPLEMENT_INDEX[seq_idx[idxs]]
        aa = translate.translate_codons(buff, xlate_code)
        if entropy_profiles is not None:
            return translate.entropy_distance_ratio(aa, *entropy_profiles)
        return translate.entropy_distance_ratio(aa)

    if entropy_cutoff is not None:
        kept = []
        for stop, frame, gene_len in orfs:
            if frame > 0:
                start = on_seq_1(stop - gene_len)
            else:
                start = on_seq_1(stop + gene_len + 2)
            if entropy_of(start, gene_len, frame) < entropy_cutoff:
                kept.append((stop, frame, gene_len))
        orfs = kept
    if not orfs:
        raise ValueError("no valid orfs found below entropy cutoff")

    ivs = get_intervals(orfs, n)
    final_len = min_gene_len
    if not fixed_min_len:
        final_len = find_optimal_len(ivs, n, min_gene_len, max_olap, circular, optimize_total)
        ivs = [v for v in ivs if final_len <= v.hi - v.lo]
    ivs = eliminate_overlapping(ivs, n, max_olap, circular)

    lines = []
    for i, v in enumerate(ivs):
        length = v.hi - v.lo
        if v.frame > 0:
            if without_stops:  # long-orfs.cc:1094: exclude the stop codon
                stop = on_seq_1(v.hi)
                start = on_seq_1(stop - length + 1)
            else:
                stop = on_seq_1(v.hi + 3)
                start = on_seq_1(stop - length - 2)
        else:
            if without_stops:
                stop = on_seq_1(v.lo + 1)
                start = on_seq_1(stop + length - 1)
            else:
                stop = on_seq_1(v.lo - 2)
                start = on_seq_1(stop + length + 2)
        # the entropy start coordinate is the same in both modes
        er = entropy_of(start, length, v.frame)
        lines.append("%05d %7d %7d  %+2d  %6.3f" % (i + 1, start, stop, v.frame, er))
    return lines, final_len
