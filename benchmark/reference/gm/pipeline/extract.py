# Frozen copy of glimmer_mg_torch/pipeline/extract.py at commit ab5a5d3.
"""Coordinate-list sequence extraction (reference src/Util/extract.cc and
multi-extract.cc): the .longorfs -> .train step of the training pipelines."""

from __future__ import annotations

from ..models import dna


def _direction(start, end, seq_len, is_circular):
    if (start < end and (not is_circular or end - start <= seq_len // 2)) or (
        is_circular and start - end > seq_len // 2
    ):
        return 1
    return -1


def _subsequence(seq: str, i: int, length: int, incr: int) -> str:
    n = len(seq)
    out = []
    for _ in range(length):
        if i < 0:
            i += n
        elif i >= n:
            i -= n
        ch = seq[i]
        out.append(ch if incr > 0 else dna.complement_str(ch))
        i += incr
    return "".join(out)


def extract(
    seq: str,
    coords_text: str,
    *,
    is_circular: bool = True,
    min_len: int = 0,
    skip_start: bool = False,
    skip_stop: bool = False,
    use_direction: bool = False,
    fasta_width: int = 60,
):
    """Yield (header, subsequence) per coord line (extract.cc:49-155)."""
    n = len(seq)
    for line in coords_text.splitlines():
        toks = line.split()
        if use_direction:
            if len(toks) < 4:
                continue
            tag, start, end, direction = toks[0], int(toks[1]), int(toks[2]), int(toks[3])
        else:
            if len(toks) < 3:
                continue
            tag, start, end = toks[0], int(toks[1]), int(toks[2])
            direction = _direction(start, end, n, is_circular)

        if direction > 0:
            extract_len = 1 + end - start
            if extract_len < 0:
                extract_len += n
            if extract_len < min_len:
                continue
            i = start - 1
            if skip_start:
                i += 3
                extract_len -= 3
                start += 3
            if skip_stop:
                extract_len -= 3
            if extract_len >= min_len:
                yield ("%s  %d %d  len=%d" % (tag, start, end, extract_len),
                       _subsequence(seq, i, extract_len, 1))
        else:
            extract_len = 1 + start - end
            if extract_len < 0:
                extract_len += n
            if extract_len < min_len:
                continue
            i = start - 1
            if skip_start:
                i -= 3
                extract_len -= 3
                start -= 3
            if skip_stop:
                extract_len -= 3
            if extract_len >= min_len:
                yield ("%s  %d %d  len=%d" % (tag, start, end, extract_len),
                       _subsequence(seq, i, extract_len, -1))
