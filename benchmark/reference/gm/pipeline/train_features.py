# Frozen copy of glimmer_mg_torch/pipeline/train_features.py at commit ab5a5d3.
"""Feature-model training from annotations or predictions.

Reimplements reference scripts/train_features.py (824-line Python2 script):
gene/non-ORF length, start-codon, adjacent-orientation and adjacent-distance
histograms from a .predict file (or parsed gene list) + sequences; writes
the .features.txt DIST blocks, the RBS upstream set + .motif (via the
ELPH-equivalent motif finder in pipeline/elph.py), the frame-corrected
.gene.fasta, and the retrained .gicm.

Faithfulness notes: codon matching is case-sensitive against uppercase
codons exactly like the reference (train_features.py:33-34 with raw input
sequence case); non-gene ORF counts are weighted 1/num_starts; orientation
counts are destranded by averaging (1,1) with (-1,-1); integer formatting
truncates floats like Python 2 '%d'.
"""

from __future__ import annotations

import dataclasses
import math

FORWARD_STARTS = ("ATG", "GTG", "TTG")
FORWARD_STOPS = ["TAG", "TAA", "TGA"]

_RC = str.maketrans("ATCGatcg", "TAGCtagc")


def rc(seq: str) -> str:
    return seq.translate(_RC)[::-1]


@dataclasses.dataclass
class Gene:
    start: int  # 0-based inclusive
    end: int  # 0-based exclusive (one past stop)
    frame_start: int
    frame_end: int
    strand: int
    start_codon: bool
    stop_codon: bool


def parse_predict(predict_text: str, seqs: dict[str, str]):
    """train_features.py:163 parse_predict. Returns {header: [Gene]}."""
    genes: dict[str, list[Gene]] = {}
    header = None
    for line in predict_text.splitlines():
        if not line.strip():
            continue
        if line[0] == ">":
            header = line[1:].rstrip()
            continue
        a = line.split()
        n = len(seqs[header])
        if int(a[3]) > 0:
            strand = 1
            start = int(a[1]) - 1
            end = int(a[2])
            start_codon = start >= 0
            stop_codon = end <= n
            frame_start = start + 3 * (1 - int(start_codon))
            frame_end = end - 3 * (1 - int(stop_codon))
        else:
            strand = -1
            start = int(a[2]) - 1
            end = int(a[1])
            stop_codon = start >= 0
            start_codon = end <= n
            frame_start = start + 3 * (1 - int(stop_codon))
            frame_end = end - 3 * (1 - int(start_codon))
        genes.setdefault(header, []).append(
            Gene(max(0, start), min(end, n), frame_start, frame_end, strand,
                 start_codon, stop_codon)
        )
    return genes


def init_stats():
    return {
        "start_codons": {sc: 0 for sc in FORWARD_STARTS},
        "lengths": {},
        "adj_orients": {(1, 1): 0, (1, -1): 0, (-1, 1): 0, (-1, -1): 0},
        "adj_dist": {(1, 1): {}, (1, -1): {}, (-1, 1): {}, (-1, -1): {}},
    }


def _bump(hist: dict, key, weight) -> None:
    hist[key] = hist.get(key, 0) + weight


def _start_codon_of(gene: Gene, hseq: str) -> str:
    """Forward-oriented start codon of a gene (<=3 chars if the gene is)."""
    body = hseq[gene.start : gene.end]
    return body[:3] if gene.strand == 1 else rc(body[-3:])


def parse_genes(stats, genes, seqs, hypothetical, min_length, max_overlap):
    """Accumulate the GENE-side feature histograms (the counts the reference
    trainer derives from annotated/predicted genes, train_features.py:223):
    amino-acid lengths, verified start-codon usage, and consecutive-gene
    orientation + distance (distances kept only within max_overlap of
    overlap; orientation pairs are (previous strand, current strand) over
    genes with a valid strand)."""
    for header, hgenes in genes.items():
        hseq = seqs[header]
        prev = None
        for gene in hgenes:
            aa_len = (gene.end - 3 - gene.start) // 3
            if gene.start not in hypothetical:
                _bump(stats["lengths"], aa_len, 1)
            if gene.strand not in (1, -1):
                continue  # also excluded from the adjacency chain
            codon = _start_codon_of(gene, hseq)
            if gene.start_codon and codon in FORWARD_STARTS:
                stats["start_codons"][codon] += 1
            if prev is not None:
                ori = (prev.strand, gene.strand)
                stats["adj_orients"][ori] += 1
                gap = gene.start - prev.end
                if -gap <= max_overlap:
                    _bump(stats["adj_dist"][ori], gap, 1)
            prev = gene


def _reverse_complement_genes(genes, seqs):
    rgenes, rseqs = {}, {}
    for header in genes:
        rseqs[header] = rc(seqs[header])
        n = len(rseqs[header])
        rgenes[header] = [
            Gene(n - g.end, n - g.start, n - g.frame_end, n - g.frame_start,
                 -g.strand, g.start_codon, g.stop_codon)
            for g in genes[header][::-1]
        ]
    return rgenes, rseqs


def _stop_positions(hseq: str) -> list[int]:
    """All positions (any frame) where a forward stop codon begins, plus the
    three virtual stops just past the sequence end (truncated ORFs).
    Vectorized byte-array matching; case-sensitive like the reference."""
    import numpy as np

    n = len(hseq)
    arr = np.frombuffer(hseq.encode("latin-1"), dtype=np.uint8)
    hit = np.zeros(max(n - 2, 0), dtype=bool)
    for stop in FORWARD_STOPS:
        if len(stop) == 3 and n >= 3:
            s = np.frombuffer(stop.encode("latin-1"), dtype=np.uint8)
            hit |= (arr[: n - 2] == s[0]) & (arr[1 : n - 1] == s[1]) & (
                arr[2:] == s[2]
            )
    return np.flatnonzero(hit).tolist() + [n, n + 1, n + 2]


def _orf_start_sites(hseq, stop_i, prev_gene_end, max_overlap):
    """Candidate start sites of the ORF ending at ``stop_i``, walking
    backwards codon by codon in frame.  Yields (position, codon) for each
    start codon — plus one virtual start with codon "" when the walk runs
    off the 5' end (ORF truncated at the sequence edge).  Stops at an
    in-frame stop codon or once a start would overlap the preceding gene
    by more than ``max_overlap``."""
    pos = stop_i - 3
    while True:
        codon = hseq[pos : pos + 3] if pos >= 0 else ""
        if codon in FORWARD_STOPS:
            return
        if codon == "" or codon in FORWARD_STARTS:
            if prev_gene_end is not None and prev_gene_end - pos > max_overlap:
                return
            yield pos, codon
        if pos < 0:
            return
        pos -= 3


def _forward_parse_nongenes(genome_strand, genes, seqs, min_length, max_overlap,
                            start_codons, lengths, adj_orients, adj_dist):
    """Accumulate the NON-side histograms from forward-strand non-gene ORFs
    (reference train_features.py:320 semantics).

    Every forward stop codon anchors a candidate ORF unless it is an
    annotated gene's stop or overlaps the next gene by more than
    ``max_overlap``.  Each candidate start contributes one length count;
    starts of at least ``min_length`` nt also contribute a start-codon
    count and orientation/distance counts against the flanking genes,
    weighted 1/num_starts so each ORF adds one unit of adjacency evidence.
    ``genome_strand=-1`` means the caller passed the reverse-complemented
    coordinate system, so orientation pairs are mirrored back.
    """
    for header, hgenes in genes.items():
        hseq = seqs[header]
        cursor = 0  # first gene whose stop codon is not before stop_i
        for stop_i in _stop_positions(hseq):
            while cursor < len(hgenes) and hgenes[cursor].end - 3 < stop_i:
                cursor += 1
            nxt = hgenes[cursor] if cursor < len(hgenes) else None
            prev = hgenes[cursor - 1] if cursor > 0 else None

            if nxt is not None:
                if nxt.end - 3 == stop_i:
                    continue  # this ORF is an annotated gene
                if stop_i + 3 - nxt.start > max_overlap:
                    continue

            sites = list(_orf_start_sites(
                hseq, stop_i, prev.end if prev is not None else None,
                max_overlap,
            ))
            num_starts = sum(
                1 for pos, _ in sites
                if 3 * ((stop_i - pos) // 3) >= min_length
            )
            for pos, codon in sites:
                aa_len = (stop_i - pos) // 3
                _bump(lengths, aa_len, 1)
                if 3 * aa_len < min_length:
                    continue
                if codon:
                    start_codons[codon] += 1
                if prev is not None:
                    ori = ((prev.strand, 1) if genome_strand == 1
                           else (-1, -prev.strand))
                    adj_orients[ori] += 1.0 / num_starts
                    _bump(adj_dist[ori], pos - prev.end, 1.0 / num_starts)
                if nxt is not None:
                    ori = ((1, nxt.strand) if genome_strand == 1
                           else (-nxt.strand, -1))
                    adj_orients[ori] += 1.0 / num_starts
                    _bump(adj_dist[ori], nxt.start - (stop_i + 3),
                          1.0 / num_starts)


def parse_nongenes(stats, genes, seqs, min_length, max_overlap):
    _forward_parse_nongenes(1, genes, seqs, min_length, max_overlap,
                            stats["start_codons"], stats["lengths"],
                            stats["adj_orients"], stats["adj_dist"])
    rgenes, rseqs = _reverse_complement_genes(genes, seqs)
    _forward_parse_nongenes(-1, rgenes, rseqs, min_length, max_overlap,
                            stats["start_codons"], stats["lengths"],
                            stats["adj_orients"], stats["adj_dist"])


def destrand_orientations(stats):
    ao = stats["adj_orients"]
    ao[(1, 1)] += ao[(-1, -1)]
    ao[(1, 1)] /= 2.0
    ao[(-1, -1)] = ao[(1, 1)]
    ad = stats["adj_dist"]
    for l in list(ad[(1, 1)].keys()) + list(ad[(-1, -1)].keys()):
        ad[(1, 1)][l] = (ad[(1, 1)].get(l, 0) + ad[(-1, -1)].get(l, 0)) / 2.0
        ad[(-1, -1)][l] = ad[(1, 1)][l]


def format_featurefile(stats, orf_type, max_overlap) -> str:
    """train_features.py:630 output_featurefile (one GENE/NON section)."""
    out = []
    out.append(f"DIST LENGTH {orf_type}")
    for l in range(1 + max(stats["lengths"].keys())):
        out.append("%d\t%d" % (l, int(stats["lengths"].get(l, 0))))
    out.append("")
    out.append(f"DIST START {orf_type}")
    for sc in FORWARD_STARTS:
        out.append("%s\t%d" % (sc, int(stats["start_codons"][sc])))
    out.append("")
    out.append(f"DIST ADJACENT_ORIENTATION {orf_type}")
    for s1 in (1, -1):
        for s2 in (1, -1):
            out.append("%d,%d\t%d" % (s1, s2, int(stats["adj_orients"][(s1, s2)])))
    out.append("")
    for s1 in (1, -1):
        for s2 in (1, -1):
            if s1 == -1 and s2 == -1:
                continue
            out.append(f"DIST ADJACENT_DISTANCE_{s1}_{s2} {orf_type}")
            d = stats["adj_dist"][(s1, s2)]
            if d:
                for l in range(-max_overlap, 1 + max(d.keys())):
                    out.append("%d\t%.1f" % (l, d.get(l, 0)))
            out.append("")
    return "\n".join(out) + "\n"


def gene_sequences(genes, seqs, hypothetical):
    """train_features.py:731 build_icm's .gene.fasta records."""
    recs = []
    for header, hgenes in genes.items():
        hseq = seqs[header]
        for gene in hgenes:
            if gene.start in hypothetical or gene.strand not in (-1, 1):
                continue
            if gene.strand == 1:
                gene_seq = hseq[gene.frame_start : gene.frame_end - 3 * int(gene.stop_codon)]
            else:
                gene_seq = rc(hseq[gene.frame_start + 3 * int(gene.stop_codon) : gene.frame_end])
            recs.append((
                "%s_%d-%d_%d%d" % (header, gene.start, gene.end,
                                   int(gene.start_codon), int(gene.stop_codon)),
                gene_seq,
            ))
    return recs


def rbs_upstream_sequences(genes, seqs, hypothetical, rbs_len=25):
    """train_features.py:682 rbs_model's upstream windows."""
    recs = []
    for header, hgenes in genes.items():
        hseq = seqs[header]
        for gene in hgenes:
            if gene.start in hypothetical:
                continue
            if gene.strand == 1 and gene.start >= rbs_len:
                recs.append(hseq[gene.start - 25 : gene.start])
            elif gene.strand == -1 and gene.end <= len(hseq) - rbs_len:
                recs.append(rc(hseq[gene.end : gene.end + 25]))
    return recs


def compute_gc(seqs) -> float:
    gc = at = 0
    for s in seqs.values():
        for ch in s:
            if ch in "AT":
                at += 1
            elif ch in "CG":
                gc += 1
    return gc / (at + gc)


def output_stats(out_prefix, stats, orf_type, max_overlap):
    """train_features.py:563 output_stats: per-feature stat files (the
    .genomeData layout consumed by glimmer-mg -c)."""
    sfx = "genes" if orf_type == "gene" else "non"
    with open(f"{out_prefix}.lengths.{sfx}.txt", "w") as out:
        if stats["lengths"]:
            for l in range(1 + max(stats["lengths"].keys())):
                out.write("%d\t%d" % (l, int(stats["lengths"].get(l, 0))) + "\n")
    with open(f"{out_prefix}.starts.{sfx}.txt", "w") as out:
        for sc in FORWARD_STARTS:
            out.write("%s\t%d\n" % (sc, int(stats["start_codons"][sc])))
    with open(f"{out_prefix}.adj_orients.{sfx}.txt", "w") as out:
        for s1 in (1, -1):
            for s2 in (1, -1):
                out.write("%d,%d\t%d\n" % (s1, s2, int(stats["adj_orients"][(s1, s2)])))
    for s1 in (1, -1):
        for s2 in (1, -1):
            if s1 == -1 and s2 == -1:
                continue
            with open(f"{out_prefix}.adj_dist.{s1}.{s2}.{sfx}.txt", "w") as out:
                d = stats["adj_dist"][(s1, s2)]
                if d:
                    for l in range(-max_overlap, 1 + max(d.keys())):
                        out.write("%d\t%.1f\n" % (l, d.get(l, 0)))


def train_genome_data(
    predict_text: str,
    seqs: dict[str, str],
    out_prefix: str,
    *,
    min_length: int = 75,
    max_overlap: int = 50,
    min_icm_bp: int = 0,
):
    """Stats-file mode (reference train_features.py without -f): writes the
    per-genome model files of the Phymm .genomeData layout, including
    .gc.txt, used by train_all.py (SURVEY P6)."""
    genes = parse_predict(predict_text, seqs)
    hypothetical: dict = {}
    gene_stats = init_stats()
    nongene_stats = init_stats()
    parse_genes(gene_stats, genes, seqs, hypothetical, min_length, max_overlap)
    parse_nongenes(nongene_stats, genes, seqs, min_length, max_overlap)
    destrand_orientations(gene_stats)
    destrand_orientations(nongene_stats)
    output_stats(out_prefix, gene_stats, "gene", max_overlap)
    output_stats(out_prefix, nongene_stats, "nongene", max_overlap)

    from . import elph

    upstream = rbs_upstream_sequences(genes, seqs, hypothetical)
    with open(f"{out_prefix}.motif", "w") as fh:
        fh.write(elph.motif_counts(upstream, width=6))

    from ..io.fasta import write_fasta
    from ..models import dna, icm as icm_mod, icm_train

    recs = gene_sequences(genes, seqs, hypothetical)
    write_fasta(f"{out_prefix}.gene.fasta", recs, width=10**9)
    bp = sum(len(s) for _, s in recs)
    if bp >= min_icm_bp and bp > 0:
        strings = icm_train.prepare_training_strings([s for _, s in recs], reverse=True)
        strings = [s for s in strings if len(s) >= 12]
        if strings:
            m = icm_train.train_icm([dna.encode(s) for s in strings])
            icm_mod.write_icm(m, f"{out_prefix}.gicm")
    with open(f"{out_prefix}.gc.txt", "w") as fh:
        fh.write("%f\n" % compute_gc(seqs))


def train_features(
    predict_text: str,
    seqs: dict[str, str],
    out_prefix: str,
    *,
    min_length: int = 75,
    max_overlap: int = 50,
    min_icm_bp: int = 0,
    mycoplasma: bool = False,
    write_featurefile: bool = True,
    indels: bool = False,
):
    """Full -f pipeline: .features.txt + .motif + .gene.fasta + .gicm."""
    global FORWARD_STOPS
    saved_stops = list(FORWARD_STOPS)
    if mycoplasma:
        FORWARD_STOPS[2] = "XXX"
    try:
        genes = parse_predict(predict_text, seqs)
        hypothetical: dict = {}

        gene_stats = init_stats()
        nongene_stats = init_stats()
        parse_genes(gene_stats, genes, seqs, hypothetical, min_length, max_overlap)
        parse_nongenes(nongene_stats, genes, seqs, min_length, max_overlap)
        destrand_orientations(gene_stats)
        destrand_orientations(nongene_stats)

        if write_featurefile:
            with open(f"{out_prefix}.features.txt", "w") as fh:
                fh.write(format_featurefile(gene_stats, "GENE", max_overlap))
                fh.write(format_featurefile(nongene_stats, "NON", max_overlap))

        # RBS motif
        from . import elph

        upstream = rbs_upstream_sequences(genes, seqs, hypothetical)
        motif_text = elph.motif_counts(upstream, width=6)
        with open(f"{out_prefix}.motif", "w") as fh:
            fh.write(motif_text)

        # gene ICM
        if indels:
            # frame-corrected extraction (train_features.py:787 + extract_aa)
            from .extract_aa import build_icm_indels

            build_icm_indels(list(seqs.items()), predict_text, out_prefix,
                             min_icm_bp=min_icm_bp)
            return gene_stats, nongene_stats

        from ..io.fasta import write_fasta
        from ..models import dna, icm as icm_mod, icm_train

        recs = gene_sequences(genes, seqs, hypothetical)
        write_fasta(f"{out_prefix}.gene.fasta", recs, width=10**9)
        bp = sum(len(s) for _, s in recs)
        if bp >= min_icm_bp and bp > 0:
            strings = icm_train.prepare_training_strings([s for _, s in recs], reverse=True)
            strings = [s for s in strings if len(s) >= 12]
            if strings:
                m = icm_train.train_icm([dna.encode(s) for s in strings])
                icm_mod.write_icm(m, f"{out_prefix}.gicm")
        return gene_stats, nongene_stats
    finally:
        FORWARD_STOPS[:] = saved_stops
