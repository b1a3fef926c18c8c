# Frozen copy of glimmer_mg_torch/models/translate.py at commit ab5a5d3.
"""Codon translation and amino-acid entropy profiles.

Reference: src/Common/xlate_tables.hh (CODON_XLATE_TABLE_*),
gene.cc:1016 Codon_Translation, gene.cc:1095 Counts_To_Entropy_Profile,
long-orfs.cc:301 / glimmer3.cc:423 Entropy_Distance_Ratio.
"""

from __future__ import annotations

import math

import numpy as np

# index = 16*b0 + 4*b1 + b2 over acgt
CODON_XLATE_TABLE_1 = "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF"

def _codon_idx(codon: str) -> int:
    a = "acgt"
    return 16 * a.index(codon[0]) + 4 * a.index(codon[1]) + a.index(codon[2])


def _variant(**changes: str) -> str:
    t = list(CODON_XLATE_TABLE_1)
    for codon, aa in changes.items():
        t[_codon_idx(codon)] = aa
    return "".join(t)


# Genbank translation tables expressed as codon diffs from the standard code
# (xlate_tables.hh:44-154, dispatched by gene.cc:1015 Codon_Translation).
# Tables 13 and 22 reproduce the reference's own table strings, which differ
# from NCBI's definitions (13: agc->G instead of agg->G; 22: taa->L instead
# of tag->L) -- parity with the binary takes precedence.
XLATE_TABLES = {
    1: CODON_XLATE_TABLE_1,
    2: _variant(aga="*", agg="*", ata="M", tga="W"),
    3: _variant(cta="T", ctc="T", ctg="T", ctt="T", ata="M", tga="W"),
    4: _variant(tga="W"),
    5: _variant(aga="S", agg="S", ata="M", tga="W"),
    6: _variant(taa="Q", tag="Q"),
    9: _variant(aaa="N", aga="S", agg="S", tga="W"),
    10: _variant(tga="C"),
    11: CODON_XLATE_TABLE_1,
    12: _variant(ctg="S"),
    13: _variant(aga="G", agc="G", ata="M", tga="W"),
    14: _variant(aaa="N", aga="S", agg="S", taa="Y", tga="W"),
    15: _variant(tag="Q"),
    16: _variant(tag="L"),
    21: _variant(aga="S", agg="S", ata="M", tga="W"),
    22: _variant(taa="L", tca="*"),
    23: _variant(tta="*"),
}
CODON_XLATE_TABLE_4 = XLATE_TABLES[4]

IS_AMINO = [c not in "BJOUXZ" for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ"]

DEFAULT_POS_ENTROPY_PROF = np.array(
    [0.08468, 0.01606, 0.05739, 0.05752, 0.04328, 0.07042, 0.02942, 0.05624,
     0.04442, 0.05620, 0.03029, 0.03975, 0.05116, 0.04098, 0.05989, 0.08224,
     0.05660, 0.06991, 0.02044, 0.03310]
)
DEFAULT_NEG_ENTROPY_PROF = np.array(
    [0.07434, 0.03035, 0.05936, 0.04729, 0.05662, 0.07704, 0.05777, 0.05328,
     0.03360, 0.05581, 0.01457, 0.03718, 0.04594, 0.05977, 0.08489, 0.05990,
     0.04978, 0.07227, 0.01050, 0.01974]
)


def xlate_table(code: int) -> str:
    """gene.cc:1037: table by Genbank number; 0 = unspecified -> standard."""
    if code == 0:
        return CODON_XLATE_TABLE_1
    try:
        return XLATE_TABLES[code]
    except KeyError:
        raise ValueError(f"ERROR:  Bad translation table = {code}") from None


def translate_codons(base_idx: np.ndarray, code: int = 0) -> np.ndarray:
    """Translate in-frame codons of an encoded sequence -> AA byte array."""
    table = np.frombuffer(xlate_table(code).encode(), dtype=np.uint8)
    n = (len(base_idx) // 3) * 3
    s = np.asarray(base_idx[:n], dtype=np.int64).reshape(-1, 3)
    return table[16 * s[:, 0] + 4 * s[:, 1] + s[:, 2]]


def counts_to_entropy_profile(count26: np.ndarray) -> np.ndarray:
    """gene.cc:1095: AA counts -> normalized entropy profile (20,)."""
    amino = np.asarray(IS_AMINO)
    total = count26[amino].sum()
    ep = np.zeros(20, dtype=np.float64)
    if total == 0:
        return ep
    ep = count26[amino].astype(np.float64) / total
    with np.errstate(divide="ignore", invalid="ignore"):
        ep = np.where(ep <= 0.0, 0.0, -ep * np.log(np.where(ep > 0, ep, 1.0)))
    return ep / ep.sum()


def entropy_distance_ratio(
    aa_bytes: np.ndarray,
    pos_profile=DEFAULT_POS_ENTROPY_PROF,
    neg_profile=DEFAULT_NEG_ENTROPY_PROF,
) -> float:
    """long-orfs.cc:301: distance to coding vs noncoding AA profiles."""
    count26 = np.zeros(26, dtype=np.int64)
    keep = aa_bytes != ord("*")
    np.add.at(count26, aa_bytes[keep] - ord("A"), 1)
    ep = counts_to_entropy_profile(count26)
    pos_dist = math.sqrt(float(((ep - pos_profile) ** 2).sum()))
    neg_dist = math.sqrt(float(((ep - neg_profile) ** 2).sum()))
    if neg_dist == 0.0:
        return 1.0 if pos_dist == 0.0 else 1e3
    return pos_dist / neg_dist
