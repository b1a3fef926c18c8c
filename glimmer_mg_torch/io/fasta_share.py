"""One rank's share of a FASTA file, read and encoded.

A file of ``S`` bytes is cut into ``parts`` contiguous byte ranges,
``[S*i//parts, S*(i+1)//parts)``; share ``i`` holds the records whose
``>`` lies in range ``i`` (a ``>`` that begins a line, as ``io.fasta``
reads lines). Each share is read from its first record's ``>`` to the
next share's, so the shares, in order, are the records of
``io.fasta.read_fasta`` of the whole file; a share may be empty.

``read_share`` gives the share as the read ids (``header.split()[0]``)
and the sequences lower-cased and encoded by ``models.dna.encode``,
concatenated, with their offsets: what ``parallel.phymm.classify_file``
makes of ``read_fasta``'s records, without a Python string a read. A
share of ASCII whose only bytes below ``!`` are spaces and newlines is
parsed with numpy; any other goes through ``read_fasta``'s own loop on
its decoded text.
"""

from __future__ import annotations

import io
import os

import numpy as np

from ..models import dna

_BLOCK = 1 << 16
_NL, _CR, _GT = 10, 13, 62
# a byte's base index: lower-cased, then encoded
_ENC = dna.SUBSCRIPT_TABLE[np.array(
    [ord(chr(c).lower()) for c in range(128)] + list(range(128, 256)))]


def next_record(fh, pos: int, size: int) -> int:
    """The offset of the first record's ``>`` at or after ``pos`` in the
    open binary file ``fh`` of ``size`` bytes, or ``size`` if none."""
    at = max(pos - 1, 0)
    prev = None  # the byte before the block, unknown for the first
    while at < size:
        fh.seek(at)
        blk = fh.read(_BLOCK)
        a = np.frombuffer(blk, np.uint8)
        gt = np.flatnonzero(a == _GT)
        for j in gt:
            p = at + int(j)
            if p < pos:
                continue
            before = a[j - 1] if j > 0 else prev
            if p == 0 or before in (_NL, _CR):
                return p
        prev = a[-1]
        at += len(blk)
    return size


def read_share(path, index: int, parts: int):
    """(ids, codes, offsets) of share ``index`` of ``parts``: the read
    ids, the reads' base indices (int8, lower-cased then ``dna.encode``d)
    end to end, and the reads' bounds in them (int64, one more than the
    reads)."""
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        start, end = (next_record(fh, size * i // parts, size)
                      for i in (index, index + 1))
        fh.seek(start)
        data = fh.read(end - start)
    a = np.frombuffer(data, np.uint8)
    low = a < 33  # the spaces, newlines and other control bytes
    lowpos = np.flatnonzero(low)
    lowb = a[lowpos]
    if a.size and (a.max() >= 128 or ((lowb != _NL) & (lowb != 32)).any()):
        return _decoded(data)
    nl = lowpos[lowb == _NL]
    starts = np.concatenate(([0], nl + 1))
    starts = starts[starts < a.size]
    heads = starts[a[starts] == _GT]
    ends = np.append(nl, a.size)[np.searchsorted(nl, heads)]
    keep = ~low
    ids = []
    for h, e in zip(heads.tolist(), ends.tolist()):
        ids.append(data[h + 1:e].decode("ascii").split()[0])
        keep[h:e] = False
    # a read's bases: its lines after the header, less spaces and newlines
    nxt = np.append(heads[1:], a.size)
    lens = (nxt - ends) - (np.searchsorted(lowpos, nxt)
                           - np.searchsorted(lowpos, ends))
    offsets = np.concatenate(([0], np.cumsum(lens))).astype(np.int64)
    return ids, _ENC[a[keep]], offsets


def _decoded(data: bytes):
    """``read_share`` of a share by ``io.fasta.read_fasta``'s loop, on
    its bytes decoded as a text file reads them."""
    ids, codes, offsets = [], [], [0]
    text = io.TextIOWrapper(io.BytesIO(data))
    header, chunks = None, []

    def close():
        ids.append(header.split()[0])
        codes.append(dna.encode("".join(chunks).lower()))
        offsets.append(offsets[-1] + len(codes[-1]))

    for line in text:
        if line.startswith(">"):
            if header is not None:
                close()
            header = line[1:].lstrip(" ").rstrip("\n")
            chunks = []
        elif header is not None:
            chunks.append("".join(line.split()))
    if header is not None:
        close()
    return (ids, np.concatenate(codes) if codes else np.zeros(0, np.int8),
            np.array(offsets, np.int64))
