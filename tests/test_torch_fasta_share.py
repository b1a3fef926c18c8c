"""``io.fasta_share``: a rank's share of a FASTA file against
``io.fasta.read_fasta`` of the whole file.

Over seeded random files (a preamble, blank lines, headers with spaces,
tabs and control bytes, empty and wrapped sequences, IUPAC codes in both
cases, a ``>`` inside a line, CR LF and lone CR line ends, a Latin-1 byte,
no final newline), the shares of 1 to 7 parts, in order, hold every read
id (``header.split()[0]``) and every sequence's ``dna.encode(s.lower())``
of ``read_fasta``; both parse routes (numpy, and the decoded text for
shares with other bytes) are taken.
"""

import random

import numpy as np
import pytest

from glimmer_mg_torch.io import fasta_share
from glimmer_mg_torch.io.fasta import read_fasta
from glimmer_mg_torch.models import dna

ALPHA = "acgtACGTnNryXx-*."


def random_fasta(rng, plain):
    """A FASTA text; ``plain`` keeps to what the numpy route takes."""
    parts = []
    if rng.random() < 0.3:
        parts.append(rng.choice(["junk\n", "\n\n", " >not\n", "x>y\n"]))
    for r in range(rng.randint(0, 12)):
        heads = ["r%d" % r, "  r%d  z" % r] if plain else [
            "r%d" % r, " r%d desc\tx" % r, "r%d\x1fz" % r, "  r%d  " % r]
        nl = "\n" if plain or rng.random() < 0.9 else rng.choice(
            ["\r\n", "\r"])
        parts.append(">" + rng.choice(heads) + nl)
        s = "".join(rng.choice(ALPHA) for _ in range(rng.randint(0, 200)))
        w = rng.randint(1, 70)
        for i in range(0, len(s), w):
            line = s[i:i + w]
            if rng.random() < 0.1:
                line = " " + line + ("  " if plain else "\t ")
            if rng.random() < 0.05:
                line += ">in"
            parts.append(line + "\n")
        if rng.random() < 0.1:
            parts.append("\n")
    if not plain and rng.random() < 0.1:
        parts.append(">r99 \xe9\nacgt\n")
    text = "".join(parts)
    return text.rstrip("\n") if rng.random() < 0.2 else text


@pytest.mark.parametrize("plain", [True, False], ids=["numpy", "decoded"])
def test_shares_are_read_fasta(tmp_path, monkeypatch, plain):
    routes = []
    real = fasta_share._decoded
    monkeypatch.setattr(fasta_share, "_decoded",
                        lambda data: routes.append(1) or real(data))
    rng = random.Random(7 if plain else 8)
    path = tmp_path / "f.fa"
    files = calls = 0
    for _ in range(120):
        path.write_bytes(random_fasta(rng, plain).encode("latin-1"))
        try:
            recs = list(read_fasta(path))
            ids = [h.split()[0] for h, _ in recs]
        except (IndexError, UnicodeDecodeError):
            continue  # the one-rank path fails there too
        files += 1
        for parts in (1, 2, 3, 4, 7):
            got_ids, got = [], []
            for i in range(parts):
                a, codes, offsets = fasta_share.read_share(path, i, parts)
                calls += 1
                assert codes.dtype == np.int8 and offsets.dtype == np.int64
                assert offsets[0] == 0 and offsets[-1] == len(codes)
                got_ids += a
                got += [codes[offsets[k]:offsets[k + 1]]
                        for k in range(len(a))]
            assert got_ids == ids
            assert len(got) == len(recs)
            for g, (_h, s) in zip(got, recs):
                assert np.array_equal(g, dna.encode(s.lower()))
    assert files > 60
    if plain:
        assert not routes  # every share by numpy
    else:
        assert 0 < len(routes) < calls
