# Frozen copy of glimmer_mg_torch/engine/orfs.py at commit ab5a5d3.
"""ORF enumeration (reference Find_Orfs, src/Glimmer/glimmer_base.cc:638-780).

The reference streams a 12-bit codon register over the sequence updating
per-frame first-start/last-start/previous-stop registers. Here the codon
classification is fully vectorized (boolean position arrays from the 12-bit
codon stream — the TPU path reuses these arrays); ORF assembly then walks
only the stop positions in global order, answering the first-start /
last-start queries with searchsorted. Output order matches the reference
exactly (stop-occurrence order; then end-of-sequence reverse ORFs per frame;
then truncated forward ORFs past the end).

Coordinate conventions (identical to the reference):
  * loop index i == 0-based subscript of a codon's LAST base,
  * a codon's "position" is the 1-based coordinate of its FIRST base = i-1,
  * Orf.stop_position: 1-based first base of the stop codon (<= 0 for
    virtual stops in front of the sequence),
  * Orf.frame: +-(1..3), determined by (last-base subscript) % 3.
"""

from __future__ import annotations

import bisect
import dataclasses

import numpy as np

from ..models import dna

INT_MAX = 2**31 - 1


@dataclasses.dataclass
class Orf:
    stop_position: int
    frame: int
    gene_len: int
    orf_len: int


@dataclasses.dataclass
class CodonPatterns:
    """Codon bit-patterns (Set_Start_And_Stop_Codons, glimmer_base.cc:2636)."""

    fwd_start: np.ndarray
    rev_start: np.ndarray
    fwd_stop: np.ndarray
    rev_stop: np.ndarray
    start_codons: tuple
    stop_codons: tuple

    @classmethod
    def make(cls, start_codons=None, stop_codons=None) -> "CodonPatterns":
        starts = tuple(start_codons or dna.DEFAULT_START_CODONS)
        stops = tuple(stop_codons or dna.DEFAULT_STOP_CODONS)
        return cls(
            fwd_start=dna.codon_masks(starts),
            rev_start=dna.codon_masks([dna.reverse_complement_str(s) for s in starts]),
            fwd_stop=dna.codon_masks(stops),
            rev_stop=dna.codon_masks([dna.reverse_complement_str(s) for s in stops]),
            start_codons=starts,
            stop_codons=stops,
        )


def scan_codons(masks: np.ndarray, pat: CodonPatterns):
    """Boolean start/stop arrays indexed by 0-based last-base subscript."""
    cod = dna.codon12_stream(masks)
    return (
        dna.can_be(cod, pat.fwd_start),
        dna.can_be(cod, pat.rev_start),
        dna.must_be(cod, pat.fwd_stop),
        dna.must_be(cod, pat.rev_stop),
    )


def _wrap_through_front(n, fr, pos, dbl_cod, pat):
    """glimmer_base.cc:2834 Wrap_Through_Front (same as long-orfs')."""
    s = (pos - 1) % 3
    check_len = n + s - pos - 4
    start_at = -1
    i = 0
    while i < check_len:
        first = s - 3
        j = (first + 2) % n + n  # last-base index in the doubled stream
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
    """glimmer_base.cc:2770 Wrap_Around_Back."""
    assert pos > 0
    check_len = pos - 1
    start_at = -1
    orf_add = 0
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


def parse_ignore_regions(text: str) -> list[tuple[int, int]]:
    """Get_Ignore_Regions (glimmer_base.cc:832-924): 1-based inclusive pairs
    -> sorted, coalesced 0-based between-coordinate ranges."""
    regions = []
    for line in text.splitlines():
        stripped = line.lstrip()
        if not stripped or stripped.startswith("#"):
            continue
        toks = line.split()
        if len(toks) < 2:
            continue
        a, b = int(toks[0]), int(toks[1])
        if a < b:
            regions.append((a - 1, b))
        else:
            regions.append((b - 1, a))
    regions.sort(key=lambda r: r[0])
    merged: list[tuple[int, int]] = []
    for lo, hi in regions:
        if merged and lo < merged[-1][1]:
            if merged[-1][1] < hi:
                merged[-1] = (merged[-1][0], hi)
        else:
            merged.append((lo, hi))
    return merged


def find_orfs(
    masks: np.ndarray,
    pat: CodonPatterns,
    min_gene_len: int = 75,
    allow_truncated: bool = False,
    allow_indel_orfs: bool = False,
    min_indel_orf_len: int = 15,
    circular: bool = False,
    ignore_regions: list[tuple[int, int]] | None = None,
) -> list[Orf]:
    n = len(masks)
    orfs: list[Orf] = []
    if n < min_gene_len:
        return orfs

    if circular:
        # 2-base overhang catches codons spanning the origin
        ext = np.concatenate([masks, masks[:2]])
        dbl_cod = dna.codon12_stream(np.concatenate([masks, masks]))
    else:
        ext = masks
        dbl_cod = None
    fwd_start, rev_start, fwd_stop, rev_stop = scan_codons(ext, pat)
    n_loop = len(ext)
    idx = np.arange(n_loop)
    det_ok = np.ones(n_loop, dtype=bool)
    if ignore_regions:
        # detections are suppressed while ignoring and until the codon
        # register refills (2 positions past the region end).
        for lo, hi in ignore_regions:
            det_ok[lo : min(hi + 2, n_loop)] = False
    fstarts = [idx[fwd_start & det_ok & ((idx % 3) == f)].tolist() for f in range(3)]
    rstarts = [idx[rev_start & det_ok & ((idx % 3) == f)].tolist() for f in range(3)]

    # Merge stop events in global subscript order; interleave ignore-region
    # boundaries (0 = finish reverse orfs at region start; 2 = reset after).
    stop_events = sorted(
        [(int(i), +1) for i in idx[fwd_stop & det_ok]]
        + [(int(i), -1) for i in idx[rev_stop & det_ok]]
        + [(lo, 0) for lo, _ in (ignore_regions or [])]
        + [(hi, 2) for _, hi in (ignore_regions or [])]
    )

    prev_fwd_stop = [0, 0, 0]  # 1-based first base of previous stop, 0 = none
    prev_rev_stop = [0, 0, 0]
    keep_len = allow_indel_orfs
    first_base = 1  # first position of the current (post-ignore) segment
    segment_bound = -1  # loop indices <= this have no usable starts
    hit_ignore = False

    def first_fwd_start_after(f: int, ref_i_exclusive: int, before_i: int) -> int:
        """1-based first base of first fwd start with subscript in
        (ref_i_exclusive, before_i); INT_MAX if none."""
        lst = fstarts[f]
        k = bisect.bisect_right(lst, max(ref_i_exclusive, segment_bound))
        if k < len(lst) and lst[k] < before_i:
            return lst[k] - 1
        return INT_MAX

    def last_rev_start_between(f: int, after_i: int, before_i: int) -> int:
        """1-based first base of last rev start with subscript in
        (after_i, before_i); 0 if none."""
        lst = rstarts[f]
        k = bisect.bisect_left(lst, before_i)
        if k > 0 and lst[k - 1] > max(after_i, segment_bound):
            return lst[k - 1] - 1
        return 0

    def do_fwd_stop(i: int, f: int):
        """Do_Fwd_Stop_Codon (glimmer_base.cc:461-506); i = loop subscript."""
        pos = i - 1
        start_pos = first_fwd_start_after(f, prev_fwd_stop[f] + 1, i)
        if prev_fwd_stop[f] == 0:
            if circular and not hit_ignore:
                # Handle_First_Forward_Stop wraparound (glimmer_base.cc:946)
                gene_len, orf_len = _wrap_through_front(n, f, pos, dbl_cod, pat)
                if gene_len == 0 and start_pos != INT_MAX:
                    gene_len = pos - start_pos
            else:
                # Handle_First_Forward_Stop, linear (glimmer_base.cc:946-974)
                orf_len = pos - first_base
                orf_len -= orf_len % 3
                gene_len = 0 if start_pos == INT_MAX else pos - start_pos
                if allow_truncated and gene_len < min_gene_len:
                    gene_len = orf_len
        else:
            gene_len = 0 if start_pos == INT_MAX else pos - start_pos
            orf_len = pos - prev_fwd_stop[f] - 3
        if gene_len >= min_gene_len or (keep_len and orf_len >= min_indel_orf_len):
            orfs.append(Orf(pos, 1 + (f + 1) % 3, gene_len, orf_len))
        prev_fwd_stop[f] = pos

    def do_rev_stop(i: int, f: int):
        """Do_Rev_Stop_Codon (glimmer_base.cc:509-539)."""
        pos = i - 1
        if prev_rev_stop[f] == 0:
            # Handle_First_Reverse_Stop (glimmer_base.cc:978-1000)
            if hit_ignore or not allow_truncated:
                gene_len = 0
                orf_stop = 0
            else:
                orf_stop = pos % 3
                if orf_stop > 0:
                    orf_stop -= 3
                last_start = last_rev_start_between(f, -1, i)
                gene_len = last_start - orf_stop
        else:
            orf_stop = prev_rev_stop[f]
            last_start = last_rev_start_between(f, orf_stop + 1, i)
            gene_len = last_start - orf_stop
        orf_len = i - orf_stop - 4
        if gene_len >= min_gene_len or (keep_len and orf_len >= min_indel_orf_len):
            orfs.append(Orf(orf_stop, -1 - (f + 1) % 3, gene_len, orf_len))
        prev_rev_stop[f] = pos

    def finish_rev_segment(last_position: int):
        """Finish_Orfs(false, ...) at an ignore-region start."""
        for f in range(3):
            if prev_rev_stop[f] == 0:
                orf_stop = (-1, 0, -2)[f]
            else:
                orf_stop = prev_rev_stop[f]
            orf_len = last_position - orf_stop - 2
            orf_len -= orf_len % 3
            last_start = last_rev_start_between(
                f, (prev_rev_stop[f] + 1) if prev_rev_stop[f] else -1, last_position
            )
            gene_len = 0 if last_start == 0 else last_start - orf_stop
            if allow_truncated and gene_len < min_gene_len:
                gene_len = orf_len
            if gene_len >= min_gene_len or (keep_len and orf_len >= min_indel_orf_len):
                orfs.append(Orf(orf_stop, -1 - (f + 1) % 3, gene_len, orf_len))

    for i0, strand in stop_events:
        if strand == 0:  # ignore-region start: finish rev orfs, start ignoring
            finish_rev_segment(i0)
            hit_ignore = True
        elif strand == 2:  # ignore-region end: reset registers
            for f in range(3):
                prev_fwd_stop[f] = 0
                prev_rev_stop[f] = 0
            first_base = i0 + 1
            segment_bound = i0 + 1  # starts usable from codon refill onward
        elif strand > 0:
            do_fwd_stop(i0, i0 % 3)
        else:
            do_rev_stop(i0, i0 % 3)

    # Finish_Orfs: end-of-sequence reverse ORFs per frame (glimmer_base.cc:783)
    for f in range(3):
        if prev_rev_stop[f] == 0:
            orf_stop = (-1, 0, -2)[f]
        else:
            orf_stop = prev_rev_stop[f]
        if circular:
            # Handle_Last_Reverse_Stop wraparound branch (glimmer_base.cc:1030)
            wrap_fr = (3 + f - (n % 3)) % 3
            gene_len, orf_len = _wrap_around_back(
                n, wrap_fr, prev_rev_stop[f], dbl_cod, pat
            )
            if gene_len == 0:
                last_start = last_rev_start_between(
                    f, (prev_rev_stop[f] + 1) if prev_rev_stop[f] else -1, n_loop + 1
                )
                if last_start > 0:
                    gene_len = last_start - prev_rev_stop[f]
        else:
            # Handle_Last_Reverse_Stop, linear branch (glimmer_base.cc:1045)
            orf_len = n - orf_stop - 2
            orf_len -= orf_len % 3
            last_start = last_rev_start_between(f, (prev_rev_stop[f] + 1) if prev_rev_stop[f] else -1, n)
            gene_len = 0 if last_start == 0 else last_start - orf_stop
            if allow_truncated and gene_len < min_gene_len:
                gene_len = orf_len
        if gene_len >= min_gene_len or (keep_len and orf_len >= min_indel_orf_len):
            orfs.append(Orf(orf_stop, -1 - (f + 1) % 3, gene_len, orf_len))

    # Truncated forward ORFs: 3 virtual stops past the end (glimmer_base.cc:771)
    if allow_truncated:
        for i in range(n, n + 3):
            do_fwd_stop(i, i % 3)

    return orfs
