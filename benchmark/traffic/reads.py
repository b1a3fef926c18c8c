"""The one general read generator: every mix is parameters for it.

A config's "reads" group says how reads of its technology look (their
length distribution, strand, classes, abundances, errors); a mix says how
many. Reads are cut from the trained genome behind each database entry.
The community is the same for every seed: abundances are log-normal
quantiles dealt out to the entries by the config's ``abundance_seed``;
the run's seed draws each read's entry by them, and its length, position,
strand, classes and errors.
"""

from __future__ import annotations

import statistics

import numpy as np

_ACGT = np.frombuffer(b"acgt", np.uint8)
_COMP = np.zeros(256, np.uint8)
_COMP[_ACGT] = np.frombuffer(b"tgca", np.uint8)
_INDEX = np.zeros(256, np.int64)
_INDEX[_ACGT] = np.arange(4)
_BATCH = 8192  # reads a pass, so that no per-base array grows large


def abundances(n, sigma, rng):
    """Relative abundances of ``n`` entries: the log-normal (sigma)
    quantiles at (i + 0.5) / n, in an order dealt by ``rng``."""
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    a = np.exp(sigma * z)
    a /= a.sum()
    return a[rng.permutation(n)]


def lengths(spec, n, rng):
    """``n`` read lengths: {"fixed": L} or {"mean", "sd", "min", "max"}
    (normal, rounded, clipped)."""
    if "fixed" in spec:
        return np.full(n, int(spec["fixed"]), np.int64)
    ln = np.rint(rng.normal(spec["mean"], spec["sd"], n))
    return np.clip(ln, spec["min"], spec["max"]).astype(np.int64)


def qualities(spec, n_bases, pos, length, rng):
    """Phred qualities of bases at positions ``pos`` of reads of
    ``length``: a mean falling from spec["start"] to spec["end"] along
    the read (quadratically), normal noise of spec["sd"], and at
    spec["dip_rate"] a dip drawn from [spec["min"], spec["dip_max"]];
    clipped to [spec["min"], spec["max"]]."""
    frac = pos / np.maximum(length - 1, 1)
    q = spec["start"] - (spec["start"] - spec["end"]) * frac ** 2
    q = np.rint(q + spec["sd"] * rng.standard_normal(n_bases))
    dip = rng.random(n_bases) < spec["dip_rate"]
    q[dip] = rng.integers(spec["min"], spec["dip_max"] + 1, int(dip.sum()))
    return np.clip(q, spec["min"], spec["max"]).astype(np.int16)


def make_reads(db, spec, n, rng, prefix="r", entries=None):
    """``n`` reads of the technology ``spec`` (a config's "reads" group)
    from the database ``db``. ``entries`` fixes each read's entry (else
    drawn by abundance). Returns (reads [(header, seq)], classes {header:
    [class strings]}, qualities {header: int16 array} or None)."""
    ne = len(db.entries)
    if entries is None:
        # the deployment's abundance profile: fixed by the config, so that
        # every seed samples the same community
        ab = abundances(ne, spec["abundance_sigma"],
                        np.random.default_rng(spec["abundance_seed"]))
        entries = rng.choice(ne, size=n, p=ab)
    entries = np.asarray(entries, np.int64)
    ln = lengths(spec["length"], n, rng)
    gidx = db.genome_of[entries]
    glen = db.genome_len[gidx]
    start = (rng.random(n) * (glen - ln + 1)).astype(np.int64)
    rc = rng.random(n) < spec["revcomp"]
    k = spec["classes"] - 1
    picks = np.argsort(rng.random((n, db.neighbours.shape[1])), axis=1)[:, :k]

    err = spec.get("errors")
    if err is not None and err["kind"] != "substitutions_from_quality":
        raise ValueError(f"unknown error kind {err['kind']!r}")
    reads, classes = [], {}
    quals = None if err is None else {}
    for lo in range(0, n, _BATCH):
        hi = min(n, lo + _BATCH)
        ln_b = ln[lo:hi]
        off = np.zeros(hi - lo + 1, np.int64)
        np.cumsum(ln_b, out=off[1:])
        read_of = np.repeat(np.arange(hi - lo), ln_b)
        pos = np.arange(int(off[-1])) - off[read_of]
        # a reverse-complemented read reads its bases back to front
        first = db.genome_start[gidx[lo:hi]] + start[lo:hi]
        flip = rc[lo:hi][read_of]
        src = first[read_of] + np.where(flip, ln_b[read_of] - 1 - pos, pos)
        buf = db.genome_flat[src]
        buf = np.where(flip, _COMP[buf], buf)
        if err is not None:
            q = qualities(err["quality"], len(buf), pos, ln_b[read_of], rng)
            hit = rng.random(len(buf)) < 10.0 ** (-q / 10.0)
            shift = rng.integers(1, 4, len(buf))
            buf[hit] = _ACGT[(_INDEX[buf[hit]] + shift[hit]) % 4]
        text = buf.tobytes().decode("ascii")
        for r in range(lo, hi):
            h = f"{prefix}{r}"
            a, b = off[r - lo], off[r - lo + 1]
            reads.append((h, text[a:b]))
            e = int(entries[r])
            classes[h] = [db.entries[e]] + [
                db.entries[int(db.neighbours[e, j])] for j in picks[r]]
            if quals is not None:
                quals[h] = q[a:b]
    return reads, classes, quals
