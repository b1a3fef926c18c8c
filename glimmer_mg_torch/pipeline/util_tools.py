"""Utility tools (reference src/Util + anomaly): coordinate/sequence
auxiliaries with byte-compatible output formats.

anomaly             src/Glimmer/anomaly.cc (gene coordinate validation)
multi-extract       src/Util/multi-extract.cc
uncovered           src/Util/uncovered.cc
window-acgt         src/Util/window-acgt.cc
start-codon-distrib src/Util/start-codon-distrib.cc
entropy-profile     src/Util/entropy-profile.cc
"""

from __future__ import annotations

import numpy as np

from ..models import dna, translate
from ..utils.stdsort import std_sort


# ---------------------------------------------------------------------------
# anomaly
# ---------------------------------------------------------------------------


def anomaly(seq: str, coords_text: str, *, start_codons=None, stop_codons=None,
            check_start=True, check_previous_stop=False):
    """Validate gene coordinates; returns (report_lines, ok_ct, problem_ct).

    anomaly.cc:37-246. Coordinates are 1-based inclusive, direction inferred
    circularly.
    """
    starts = tuple(start_codons or dna.DEFAULT_START_CODONS)
    stops = tuple(stop_codons or dna.DEFAULT_STOP_CODONS)
    n = len(seq)
    data = "x" + seq  # 1-based indexing
    out = []
    ok_ct = problem_ct = 0

    def is_stop(c):
        return c in stops

    def is_start(c):
        return c in starts

    for line in coords_text.splitlines():
        toks = line.split()
        if len(toks) < 3:
            if line.strip():
                out.append(f"Bad line:  {line}\n...Skipping")
            continue
        name, start, end = toks[0], int(toks[1]), int(toks[2])
        problem = False
        if (start < end and end - start <= n // 2) or (start - end > n // 2):
            direction = 1
            gene_len = 1 + end - start
            if gene_len < 0:
                gene_len += n
            buf = "".join(
                data[start + i if start + i <= n else start + i - n].lower()
                for i in range(gene_len)
            )
        else:
            direction = -1
            gene_len = 1 + start - end
            if gene_len < 0:
                gene_len += n
            buf = "".join(
                dna.complement_str(
                    data[start - i if start - i >= 1 else start - i + n].lower()
                )
                for i in range(gene_len)
            )

        if check_previous_stop:
            cod = [""] * 3
            for i in (3, 2, 1):
                if direction == 1:
                    j = start - i if start - i >= 1 else start - i + n
                    cod[3 - i] = data[j].lower()
                else:
                    j = start + i if start + i <= n else start + i - n
                    cod[3 - i] = dna.complement_str(data[j].lower())
            if not is_stop("".join(cod)):
                out.append("%-10s %8d %8d no stop before start" % (name, start, end))
                problem = True

        if check_start and not is_start(buf[:3]):
            out.append("%-10s has bad start codon = %.3s" % (name, buf))
            problem = True
        if not is_stop(buf[gene_len - 3 : gene_len]):
            out.append("%-10s has bad stop codon = %s" % (name, buf[gene_len - 3 :]))
            problem = True
            j = gene_len
            while j < n:
                cod = []
                for i in range(3):
                    if direction == 1:
                        k = start + i + j
                        k = k - n if k > n else k
                        cod.append(data[k].lower())
                    else:
                        k = start - i - j
                        k = k + n if k < 1 else k
                        cod.append(dna.complement_str(data[k].lower()))
                if is_stop("".join(cod)):
                    break
                j += 3
            out.append(
                "           next stop occurs at offset %d  Gene_Len = %d  diff = %+d"
                % (j, gene_len, j - gene_len + 3)
            )

        frame_shift = gene_len % 3
        if frame_shift:
            out.append(
                "%-10s %8d %8d has %+d frame shift" % (name, start, end, frame_shift)
            )
            problem = True
            i = 0
            while i < gene_len - 3 and not is_stop(buf[i : i + 3]):
                i += 3
            if i < gene_len - 3:
                stop = start + direction * (i - 1)
                if stop < 1:
                    stop += n
                elif stop > n:
                    stop -= n
                out.append("   Best prefix is %8d %8d   Len = %d" % (start, stop, i))
            else:
                out.append("   No stop found in start frame")
                if problem:
                    problem_ct += 1
                continue
            i = gene_len - 6
            while i >= 0 and not is_stop(buf[i : i + 3]):
                i -= 3
            i += 3
            begin = start + direction * i
            if begin < 1:
                begin += n
            elif stop > n:  # reference's own variable reuse quirk
                begin -= n
            out.append(
                "   Best suffix is %8d %8d   Len = %d" % (begin, end, gene_len - i - 3)
            )
        else:
            i = 0
            while i < gene_len - 3:
                if is_stop(buf[i : i + 3]):
                    out.append(
                        "%-10s has stop codon %.3s at offset %d  Gene_Len = %d  diff = %+d"
                        % (name, buf[i : i + 3], i, gene_len, gene_len - 3 - i)
                    )
                    problem = True
                i += 3
        if problem:
            problem_ct += 1
        else:
            ok_ct += 1

    return out, ok_ct, problem_ct


# ---------------------------------------------------------------------------
# uncovered
# ---------------------------------------------------------------------------


def uncovered(seq: str, coords_text: str, *, is_circular=True, min_len=0,
              skip_start=False, skip_stop=False, use_direction=False):
    """Regions of seq not covered by the coordinate list (uncovered.cc)."""
    from .extract import _direction

    n = len(seq)
    regions = []
    for line in coords_text.splitlines():
        toks = line.split()
        if use_direction:
            if len(toks) < 4:
                continue
            tag, start, end, d = toks[0], int(toks[1]), int(toks[2]), int(toks[3])
        else:
            if len(toks) < 3:
                continue
            tag, start, end = toks[0], int(toks[1]), int(toks[2])
            d = _direction(start, end, n, is_circular)
        if d > 0:
            extract_len = 1 + end - start
            if extract_len < 0:
                extract_len += n
            i = start - 1
            if skip_start:
                i += 3
                extract_len -= 3
            if skip_stop:
                extract_len -= 3
            j = i + extract_len
            if j <= n:
                regions.append((i, j))
            else:
                regions.append((i, n))
                regions.append((0, j - n))
        else:
            extract_len = 1 + start - end
            if extract_len < 0:
                extract_len += n
            i = start
            if skip_start:
                i -= 3
                extract_len -= 3
            if skip_stop:
                extract_len -= 3
            j = i - extract_len
            if j >= 0:
                regions.append((j, i))
            else:
                regions.append((0, i))
                regions.append((n + j, n))

    regions.sort()
    merged = []
    for lo, hi in regions:
        if merged and lo <= merged[-1][1]:
            if merged[-1][1] < hi:
                merged[-1] = (merged[-1][0], hi)
        else:
            merged.append((lo, hi))

    out = []
    a = 0
    ct = 0
    for lo, hi in merged:
        length = lo - a
        if length > 0 and length >= min_len:
            ct += 1
            out.append(("seq%05d  %d %d  len=%d" % (ct, a + 1, lo, length), seq[a:lo]))
        a = hi
    length = n - a
    if length > 0 and length >= min_len:
        ct += 1
        out.append(("seq%05d  %d %d  len=%d" % (ct, a + 1, n, length), seq[a:n]))
    return out


# ---------------------------------------------------------------------------
# window-acgt
# ---------------------------------------------------------------------------


def window_acgt(fasta_text: str, window_len: int, window_skip: int,
                percents=False) -> str:
    """Windowed base-composition report (window-acgt.cc)."""
    sub = {"a": 0, "c": 1, "g": 2, "t": 3}
    out = []

    def pct(x, tot):
        return 0.0 if tot == 0 else 100.0 * x / tot

    def print_line(pos, size, count):
        row = "%8d %7d" % (pos, size)
        if percents:
            row += "".join(" %6.1f" % pct(c, size) for c in count)
        else:
            row += "".join(" %6d" % c for c in count)
        row += " %6.1f" % pct(count[1] + count[2], size)
        out.append(row)

    window = [None] * window_len
    win_pos = win_next = 1
    win_sub = win_size = last_pos = 0
    count = [0] * 5

    def finish():
        nonlocal win_pos, win_size, win_sub
        while win_pos < win_next and win_size > 0:
            count[sub.get(window[win_sub].lower(), 4)] -= 1
            win_pos += 1
            win_size -= 1
            win_sub = (win_sub + 1) % window_len
        if win_size > 0:
            print_line(win_pos, win_size, count)

    for line in fasta_text.splitlines(keepends=True):
        if line.lstrip()[:1] == ">":
            if win_pos != last_pos:
                finish()
            out.append(line.rstrip("\n"))
            out.append(
                "%8s %7s %6s %6s %6s %6s %6s %6s"
                % ("Position", "Length", "As", "Cs", "Gs", "Ts", "Other", "%GC")
            )
            win_pos = win_next = 1
            win_sub = win_size = last_pos = 0
            count = [0] * 5
        else:
            for ch in line:
                if not ch.isspace():
                    if win_size == window_len:
                        count[sub.get(window[win_sub].lower(), 4)] -= 1
                        win_pos += 1
                    else:
                        win_size += 1
                    count[sub.get(ch.lower(), 4)] += 1
                    window[win_sub] = ch
                    win_sub = (win_sub + 1) % window_len
                    if win_size == window_len and win_pos == win_next:
                        print_line(win_pos, win_size, count)
                        last_pos = win_pos
                        win_next += window_skip
    if win_pos != last_pos:
        finish()
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# start-codon-distrib
# ---------------------------------------------------------------------------


def start_codon_distrib(seq: str, coords_text: str, *, is_circular=True,
                        use_direction=False, comma3=False) -> str:
    """Start-codon usage counts (start-codon-distrib.cc)."""
    from .extract import _direction

    n = len(seq)

    def seq_sub_ref(s):
        s -= 1
        while s < 0:
            s += n
        while n - 1 <= s:
            s -= n
        return s

    counts: dict[str, int] = {}
    total = 0
    for line in coords_text.splitlines():
        toks = line.split()
        if use_direction:
            if len(toks) < 4:
                continue
            start, end, d = int(toks[1]), int(toks[2]), int(toks[3])
        else:
            if len(toks) < 3:
                continue
            start, end = int(toks[1]), int(toks[2])
            d = _direction(start, end, n, is_circular)
        if d > 0:
            codon = "".join(seq[seq_sub_ref(start + i)].lower() for i in range(3))
        else:
            codon = "".join(
                dna.complement_str(seq[seq_sub_ref(start - i)].lower())
                for i in range(3)
            )
        counts[codon] = counts.get(codon, 0) + 1
        total += 1

    if comma3:
        t = max(total, 1)
        return "%.3f,%.3f,%.3f\n" % (
            counts.get("atg", 0) / t, counts.get("gtg", 0) / t,
            counts.get("ttg", 0) / t,
        )
    items = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    out = []
    for codon, ct in items:
        p = 0.0 if total == 0 else 100.0 * ct / total
        out.append(" %s   %6d  %5.1f%%" % (codon, ct, p))
    out.append("Total: %6d" % total)
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# multi-extract
# ---------------------------------------------------------------------------


def multi_extract(seq_records, coords_text: str, *, is_circular=True,
                  min_len=0, skip_start=False, skip_stop=False,
                  use_direction=False):
    """Tag-keyed extraction over multiple sequences (multi-extract.cc)."""
    from .extract import _direction, _subsequence

    coords = []
    for line in coords_text.splitlines():
        toks = line.split()
        if use_direction:
            if len(toks) < 5:
                continue
            coords.append((toks[0], toks[1], int(toks[2]), int(toks[3]), int(toks[4])))
        else:
            if len(toks) < 4:
                continue
            coords.append((toks[0], toks[1], int(toks[2]), int(toks[3]), 0))
    std_sort(coords, lambda a, b: a[1] < b[1])

    for header, seq in seq_records:
        tag = header.split()[0]
        block = [c for c in coords if c[1] == tag]
        n = len(seq)
        for cid, _, start, end, d in block:
            if not use_direction:
                d = _direction(start, end, n, is_circular)
            if d > 0:
                extract_len = 1 + end - start
                if extract_len < 0:
                    extract_len += n
                loc = start - 1
                if skip_start:
                    loc += 3
                    extract_len -= 3
                    start += 3
                if skip_stop:
                    extract_len -= 3
                if extract_len >= min_len:
                    yield ("%s  %s  %d %d  len=%d" % (cid, tag, start, end, extract_len),
                           _subsequence(seq, loc, extract_len, 1))
            else:
                extract_len = 1 + start - end
                if extract_len < 0:
                    extract_len += n
                loc = start - 1
                if skip_start:
                    loc -= 3
                    extract_len -= 3
                    start -= 3
                if skip_stop:
                    extract_len -= 3
                if extract_len >= min_len:
                    yield ("%s  %s  %d %d  len=%d" % (cid, tag, start, end, extract_len),
                           _subsequence(seq, loc, extract_len, -1))


# ---------------------------------------------------------------------------
# entropy-score / entropy-fasta
# ---------------------------------------------------------------------------


def _entropy_ratio_of(base_idx) -> float:
    aa = translate.translate_codons(base_idx)
    return translate.entropy_distance_ratio(aa)


def entropy_score(seq: str, coords_text: str, *, is_circular=True, min_len=0,
                  skip_start=False, skip_stop=False, use_direction=False) -> str:
    """Entropy-distance ratio per coordinate-list region (entropy-score.cc)."""
    from .extract import _direction

    n = len(seq)
    idx_all = dna.encode(seq)
    out = []
    for line in coords_text.splitlines():
        toks = line.split()
        if use_direction:
            if len(toks) < 4:
                continue
            start, end, d = int(toks[1]), int(toks[2]), int(toks[3])
        else:
            if len(toks) < 3:
                continue
            start, end = int(toks[1]), int(toks[2])
            d = _direction(start, end, n, is_circular)
        if d > 0:
            extract_len = 1 + end - start
            if extract_len < 0:
                extract_len += n
            i = start - 1
            if skip_start:
                i += 3
                extract_len -= 3
            if skip_stop:
                extract_len -= 3
            if extract_len < min_len:
                continue
            pos = (i % n + np.arange(extract_len)) % n
            buff = idx_all[pos]
        else:
            extract_len = 1 + start - end
            if extract_len < 0:
                extract_len += n
            i = start - 1
            if skip_start:
                i -= 3
                extract_len -= 3
            if skip_stop:
                extract_len -= 3
            if extract_len < min_len:
                continue
            pos = (i % n - np.arange(extract_len)) % n
            buff = dna.COMPLEMENT_INDEX[idx_all[pos]]
        out.append("%s \t%5.3f" % (line.rstrip("\n"), _entropy_ratio_of(buff)))
    return "\n".join(out) + "\n" if out else ""


def entropy_fasta(seq_records) -> str:
    """Annotate fasta records with their entropy ratio (entropy-fasta.cc)."""
    out = []
    for header, s in seq_records:
        if len(s) % 3 != 0:
            raise ValueError(f"{header} not divisible by 3")
        ratio = _entropy_ratio_of(dna.encode(s.lower()))
        out.append(">%s\t%g\n%s" % (header, ratio, s))
    return "\n".join(out) + "\n" if out else ""


# ---------------------------------------------------------------------------
# entropy-profile
# ---------------------------------------------------------------------------


def entropy_profile(seq_records, min_len: int = 0, brief=True) -> str:
    """AA entropy profiles of a gene set, fwd + revcomp (entropy-profile.cc;
    implements the documented intent — the reference binary dereferences an
    uninitialized pointer for the reverse strand)."""
    count = np.zeros(26, dtype=np.int64)
    rev_count = np.zeros(26, dtype=np.int64)
    for _, s in seq_records:
        n = len(s)
        if n < min_len or n % 3 != 0:
            continue
        idx = dna.encode(s.lower())
        aa = translate.translate_codons(idx)
        keep = aa != ord("*")
        np.add.at(count, aa[keep] - ord("A"), 1)
        raa = translate.translate_codons(dna.revcomp_index(idx).copy())
        keep = raa != ord("*")
        np.add.at(rev_count, raa[keep] - ord("A"), 1)
    ep = translate.counts_to_entropy_profile(count)
    rev_ep = translate.counts_to_entropy_profile(rev_count)
    out = ["AA  %8s  %8s" % ("Positive", "Negative")]
    j = 0
    for i in range(26):
        if translate.IS_AMINO[i]:
            out.append(" %c  %8.5f  %8.5f" % (chr(ord("A") + i), ep[j], rev_ep[j]))
            j += 1
    return "\n".join(out) + "\n"
