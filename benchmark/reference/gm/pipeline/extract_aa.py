# Frozen copy of glimmer_mg_torch/pipeline/extract_aa.py at commit ab5a5d3.
"""Gene nt/aa extraction from .predict files with indel correction.

Faithful port of reference scripts/extract_aa.py (391 lines, Python 2):
builds a pseudo-MSA of the read against its predicted error set
(insertions/deletions/substitutions from the I:/D:/S: fields), then walks
each gene's frame through the alignment emitting frame-corrected DNA and
protein sequences (the .ffn/.faa pair used to retrain ICMs in indel mode,
train_features.py:787-802).
"""

from __future__ import annotations

import dataclasses

_RC = str.maketrans("ATCGatcg", "TAGCtagc")

_CODE = {}
_BASES = "TCAG"
_AAS = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
for _i, _b1 in enumerate(_BASES):
    for _j, _b2 in enumerate(_BASES):
        for _k, _b3 in enumerate(_BASES):
            aa = _AAS[16 * _i + 4 * _j + _k]
            _CODE[_b1 + _b2 + _b3] = aa
            _CODE[(_b1 + _b2 + _b3).lower()] = aa.lower() if aa != "*" else "*"


def rc(seq: str) -> str:
    return seq.translate(_RC)[::-1]


def translate(dna: str) -> str:
    if len(dna) % 3 != 0:
        return ""
    return "".join(_CODE.get(dna[i : i + 3], "X") for i in range(0, len(dna), 3))


@dataclasses.dataclass
class Pred:
    start: int
    end: int
    strand: int
    start_codon: bool
    stop_codon: bool
    insertions: list
    deletions: list
    substitutions: list


def get_preds(seqs: dict[str, str], predict_text: str) -> dict[str, list[Pred]]:
    """extract_aa.py:66 get_preds: parse predictions with indel adjustment."""
    frag_lengths = {h: len(s) for h, s in seqs.items()}
    frag_preds: dict[str, list[Pred]] = {}
    header = None
    indel_plusminus = 0
    for line in predict_text.splitlines():
        if not line.strip():
            continue
        if line[0] == ">":
            header = line[1:].rstrip()
            frag_preds[header] = []
            indel_plusminus = 0
            continue
        a = line.split()
        insertions = [int(x) - 1 for x in a[5][2:].split(",")] if len(a[5]) > 2 else []
        deletions = [int(x) - 1 for x in a[6][2:].split(",")] if len(a[6]) > 2 else []
        substitutions = [int(x) - 1 for x in a[7][2:].split(",")] if len(a[7]) > 2 else []
        if int(a[3]) > 0:
            strand = 1
            start = int(a[1]) - 1 + indel_plusminus
            indel_plusminus += len(deletions) - len(insertions)
            end = int(a[2]) + indel_plusminus
            start_codon = start >= 0
            stop_codon = end <= frag_lengths[header] + indel_plusminus
        else:
            strand = -1
            start = int(a[2]) - 1 + indel_plusminus
            indel_plusminus += len(deletions) - len(insertions)
            end = int(a[1]) + indel_plusminus
            stop_codon = start >= 0
            start_codon = end <= frag_lengths[header] + indel_plusminus
        frag_preds[header].append(
            Pred(start, end, strand, start_codon, stop_codon,
                 insertions, deletions, substitutions)
        )
    for header in frag_preds:
        frag_preds[header].sort(key=lambda p: p.start)
    return frag_preds


def predict_msa(preds: list[Pred], seq: str) -> list[str]:
    """Predicted-sequence row of the fragment/prediction pseudo-alignment.

    Behavioral parity with reference scripts/extract_aa.py:143: walk the
    fragment left to right, consuming the gene predictions' pooled error
    coordinates (fragment-indexed, sorted, earliest-first; at equal
    positions an insertion outranks a deletion outranks a substitution):

      * insertion  — the fragment base is an artifact: emit a gap.
      * deletion   — the fragment is missing a base: emit a guessed base
        (copy of the previous emitted one — sequencer indels are
        overwhelmingly homopolymer-length errors) and then the fragment
        base itself.
      * substitution — emit a miscall marker in place of the base ("C",
        or "G" when the base already is a C), matching the reference's
        placeholder choice so retraining sets are identical.

    Output is a char list padded with 3 leading spaces and enough trailing
    spaces to reach ``len(seq) + 6 + #deletions`` (one extra emitted char
    per deletion), exactly the reference's allocation.  Error coordinates
    that repeat or never match simply fall through, as in the reference.
    """
    frag_row = [" "] * 3 + list(seq) + [" "] * 3
    pending = {
        kind: sorted(sum((getattr(p, kind) for p in preds), []))
        for kind in ("insertions", "deletions", "substitutions")
    }
    if not any(pending.values()):
        return frag_row

    out_len = len(frag_row) + len(pending["deletions"])
    out = [" "] * 3

    def next_is(kind, f):
        lst = pending[kind]
        if lst and lst[0] == f:
            lst.pop(0)
            return True
        return False

    for f, base in enumerate(seq):
        if next_is("insertions", f):
            out.append("-")
        elif next_is("deletions", f):
            out.append(out[-1])  # homopolymer guess for the missing base
            out.append(base)
        elif next_is("substitutions", f):
            out.append("G" if base == "C" else "C")
        else:
            out.append(base)
    out.extend([" "] * (out_len - len(out)))
    return out


def frag_genes(header: str, seq: str, preds: list[Pred]):
    """extract_aa.py:232 print_frag_genes: yields (header, dna, aa)."""
    pred_msa = predict_msa(preds, seq)
    for g in preds:
        gene_seq = ""
        s = -3
        gene_frame = 0
        for m in range(len(pred_msa)):
            if pred_msa[m] != "-":
                if g.strand == 1:
                    if g.start <= s < g.start + 3:
                        gene_frame = 1
                        if len(gene_seq) > 0 or (s == g.start and s >= 0):
                            gene_seq += pred_msa[m]
                    elif g.end - 3 <= s < g.end:
                        gene_frame = 0
                    elif gene_frame > 0:
                        gene_frame = 1 + (gene_frame % 3)
                        if len(gene_seq) > 0 or (gene_frame == 2 and s >= 0):
                            gene_seq += pred_msa[m]
                else:
                    if g.start <= s < g.start + 3:
                        gene_frame = 9
                    elif g.end - 3 <= s < g.end:
                        gene_frame = 0
                        if pred_msa[m] != " ":
                            gene_seq += pred_msa[m]
                    elif gene_frame > 0:
                        gene_frame -= 1
                        if gene_frame == 6:
                            gene_frame = 9
                        if len(gene_seq) > 0 or (gene_frame == 8 and s >= 0):
                            gene_seq += pred_msa[m]
                s += 1
        gene_seq = gene_seq[: 3 * (len(gene_seq) // 3)]
        if g.strand == 1:
            dna_seq = gene_seq
            strand = "+"
        else:
            dna_seq = rc(gene_seq)
            strand = "-"
        tag = "%s_%d,%d_%s" % (header, g.start, g.end, strand)
        yield tag, dna_seq, translate(dna_seq)


def extract_aa(seqs_items, predict_text: str):
    """Yields (tag, dna, aa) for all fragments in order."""
    seqs = dict(seqs_items)
    frag_preds = get_preds(seqs, predict_text)
    for header, seq in seqs_items:
        for rec in frag_genes(header, seq, frag_preds.get(header, [])):
            yield rec


def build_icm_indels(seqs_items, predict_text: str, out_prefix: str,
                     min_icm_bp: int = 0) -> None:
    """train_features.py:787 build_icm_indels: frame-corrected gene fasta +
    retrained .gicm."""
    from ..io.fasta import write_fasta
    from ..models import dna as dna_mod, icm as icm_mod, icm_train

    recs = [(tag, dna) for tag, dna, _ in extract_aa(seqs_items, predict_text)]
    write_fasta(f"{out_prefix}.gene.fasta", recs, width=10**9)
    bp = sum(len(s) for _, s in recs)
    if bp >= min_icm_bp and bp > 0:
        strings = icm_train.prepare_training_strings([s for _, s in recs], reverse=True)
        strings = [s for s in strings if len(s) >= 12]
        if strings:
            m = icm_train.train_icm([dna_mod.encode(s) for s in strings])
            icm_mod.write_icm(m, f"{out_prefix}.gicm")
