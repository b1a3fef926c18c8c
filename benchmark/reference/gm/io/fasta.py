# Frozen copy of glimmer_mg_torch/io/fasta.py at commit ab5a5d3.
"""FASTA and FASTA-quality file I/O.

Parity with reference src/Common/fasta.cc: ``Fasta_Read`` (fasta.cc:236)
takes the full header line after '>' (leading spaces stripped) and
concatenates all non-whitespace sequence characters; ``Fasta_Qual_Vec_Read``
(fasta.cc:113) parses whitespace-separated integer quality values.
"""

from __future__ import annotations

from typing import Iterator


def read_fasta(path) -> Iterator[tuple[str, str]]:
    """Yield (header, sequence) pairs. Header excludes '>' and leading spaces;
    sequence keeps original case (callers lowercase when needed)."""
    header = None
    chunks: list[str] = []
    with open(path, "r") as fh:
        for line in fh:
            if line.startswith(">"):
                if header is not None:
                    yield header, "".join(chunks)
                header = line[1:].lstrip(" ").rstrip("\n")
                chunks = []
            elif header is not None:
                chunks.append("".join(line.split()))
    if header is not None:
        yield header, "".join(chunks)


def read_fasta_dict(path) -> dict[str, str]:
    return dict(read_fasta(path))


def read_qual(path) -> Iterator[tuple[str, list[int]]]:
    """Yield (header, [quality ints]) from a FASTA-like quality file."""
    header = None
    vals: list[int] = []
    with open(path, "r") as fh:
        for line in fh:
            if line.startswith(">"):
                if header is not None:
                    yield header, vals
                header = line[1:].lstrip(" ").rstrip("\n")
                vals = []
            elif header is not None:
                vals.extend(int(tok) for tok in line.split())
    if header is not None:
        yield header, vals


def write_fasta(path_or_fh, records, width: int = 60) -> None:
    """Write (header, seq) records, ``width`` chars/line (fasta.cc:14)."""
    own = isinstance(path_or_fh, (str, bytes)) or hasattr(path_or_fh, "__fspath__")
    fh = open(path_or_fh, "w") if own else path_or_fh
    try:
        for header, seq in records:
            if header is not None:
                fh.write(f">{header}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width])
                fh.write("\n")
            if len(seq) == 0:
                fh.write("\n")
    finally:
        if own:
            fh.close()
