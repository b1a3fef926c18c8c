# Frozen copy of glimmer_mg_torch/models/dna.py at commit ab5a5d3.
"""DNA alphabet encoding for TPU-friendly integer representations.

Behavioral parity targets in the reference implementation:
  - ``Subscript``/``Filter`` (reference src/ICM/icm.cc:2008, src/Common/gene.cc:1139):
    maps any byte to an index in "acgt" with fixed IUPAC disambiguation.
  - ``Ch_Mask`` (reference src/Common/gene.cc:315): 4-bit "can-be" mask with
    bit 0=a, 1=c, 2=g, 3=t.
  - ``COMPLEMENT_TABLE`` (reference src/Common/gene.cc:15).

Everything here is plain numpy: these tables are tiny, built once at import,
and used by both the host-side exact engines and the device kernels (which
consume the resulting int8/int32 arrays).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Subscript(Filter(ch)): byte -> 0..3 index into "acgt"
# ---------------------------------------------------------------------------

_FILTER_MAP = {
    "a": 0, "c": 1, "g": 2, "t": 3,
    "r": 2,  # a or g -> g
    "y": 1,  # c or t -> c
    "s": 1,  # c or g -> c
    "w": 3,  # a or t -> t
    "m": 1,  # a or c -> c
    "k": 3,  # g or t -> t
    "b": 1,  # c, g or t -> c
    "d": 2,  # a, g or t -> g
    "h": 1,  # a, c or t -> c
    "v": 1,  # a, c or g -> c
}

#: 256-entry byte -> base-index table (default 'c' = 1, as in the reference).
SUBSCRIPT_TABLE = np.full(256, 1, dtype=np.int8)
for _ch, _idx in _FILTER_MAP.items():
    SUBSCRIPT_TABLE[ord(_ch)] = _idx
    SUBSCRIPT_TABLE[ord(_ch.upper())] = _idx

# ---------------------------------------------------------------------------
# Ch_Mask: byte -> 4-bit IUPAC "can-be" mask (a=1, c=2, g=4, t=8)
# ---------------------------------------------------------------------------

_CH_MASK_MAP = {
    "a": 0x1, "c": 0x2, "g": 0x4, "t": 0x8,
    "r": 0x5, "y": 0xA, "s": 0x6, "w": 0x9, "m": 0x3, "k": 0xC,
    "b": 0xE, "d": 0xD, "h": 0xB, "v": 0x7, "n": 0xF,
}

#: 256-entry byte -> 4-bit mask table (default 0 = "nothing").
CH_MASK_TABLE = np.zeros(256, dtype=np.uint8)
for _ch, _m in _CH_MASK_MAP.items():
    CH_MASK_TABLE[ord(_ch)] = _m
    CH_MASK_TABLE[ord(_ch.upper())] = _m

# ---------------------------------------------------------------------------
# Complement (IUPAC-aware, case-preserving like the reference table)
# ---------------------------------------------------------------------------

_COMP_MAP = {
    "a": "t", "c": "g", "g": "c", "t": "a", "u": "n",
    "r": "y", "y": "r", "s": "s", "w": "w", "k": "m", "m": "k",
    "b": "v", "v": "b", "d": "h", "h": "d", "n": "n",
    "*": "*", "-": "-", ".": ".", "_": "_", " ": " ",
}

#: 256-entry byte -> complement byte table (default 'n').
COMPLEMENT_TABLE = np.full(256, ord("n"), dtype=np.uint8)
for _ch, _cc in _COMP_MAP.items():
    if _ch.isalpha():
        COMPLEMENT_TABLE[ord(_ch)] = ord(_cc)
        COMPLEMENT_TABLE[ord(_ch.upper())] = ord(_cc.upper())
    else:
        COMPLEMENT_TABLE[ord(_ch)] = ord(_cc)

#: base-index (0..3) complement: a<->t, c<->g
COMPLEMENT_INDEX = np.array([3, 2, 1, 0], dtype=np.int8)

ALPHABET = "acgt"


def encode(seq) -> np.ndarray:
    """Encode a DNA string/bytes to int8 base indices (0..3).

    Ambiguous IUPAC codes are disambiguated exactly like the reference's
    ``Subscript(Filter(ch))``.
    """
    if isinstance(seq, str):
        seq = seq.encode("latin-1")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return SUBSCRIPT_TABLE[raw]


def encode_masks(seq) -> np.ndarray:
    """Encode a DNA string/bytes to 4-bit IUPAC can-be masks (uint8)."""
    if isinstance(seq, str):
        seq = seq.encode("latin-1")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return CH_MASK_TABLE[raw]


def decode(idx: np.ndarray) -> str:
    """Base indices (0..3) -> lowercase acgt string."""
    lut = np.frombuffer(b"acgt", dtype=np.uint8)
    return lut[np.asarray(idx, dtype=np.int64)].tobytes().decode("latin-1")


def complement_str(seq: str) -> str:
    raw = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    return COMPLEMENT_TABLE[raw].tobytes().decode("latin-1")


def reverse_complement_str(seq: str) -> str:
    return complement_str(seq)[::-1]


def revcomp_index(idx: np.ndarray) -> np.ndarray:
    """Reverse-complement an array of base indices."""
    return COMPLEMENT_INDEX[np.asarray(idx)][::-1]


def codon_masks(patterns) -> np.ndarray:
    """Codon strings -> 12-bit Codon_t masks (int32), 4 bits per base.

    Bit layout matches reference ``Codon_t::Shift_In`` (gene.cc:147): the
    first base occupies bits 8..11, the last base bits 0..3.
    """
    out = np.zeros(len(patterns), dtype=np.int32)
    for i, pat in enumerate(patterns):
        m = 0
        for ch in pat[:3]:
            m = ((m & 0xFF) << 4) | int(CH_MASK_TABLE[ord(ch)])
        out[i] = m
    return out


def can_be(codon12: np.ndarray, patterns12: np.ndarray) -> np.ndarray:
    """Vectorized Codon_t::Can_Be over an array of 12-bit codons.

    True where the codon could match ANY of the patterns.
    """
    c = codon12[..., None] & patterns12  # broadcast over patterns
    ok = ((c & 0xF00) != 0) & ((c & 0x0F0) != 0) & ((c & 0x00F) != 0)
    return ok.any(axis=-1)


def must_be(codon12: np.ndarray, patterns12: np.ndarray) -> np.ndarray:
    """Vectorized Codon_t::Must_Be: codon can only be one of the patterns."""
    c = codon12[..., None] & patterns12
    ok = (c == codon12[..., None]) & (
        ((codon12 & 0xF00) != 0)
        & ((codon12 & 0x0F0) != 0)
        & ((codon12 & 0x00F) != 0)
    )[..., None]
    return ok.any(axis=-1)


def codon12_stream(masks: np.ndarray) -> np.ndarray:
    """Per-position 12-bit codon registers for a mask-encoded sequence.

    ``out[i]`` is the codon whose LAST base is position ``i`` (i.e., covers
    positions i-2, i-1, i), exactly like streaming ``Shift_In`` over the
    sequence. Positions < 2 contain partial codons (high nibbles zero),
    matching a ``Codon_t`` freshly cleared then shifted i+1 times.
    """
    m = masks.astype(np.int32)
    n = m.shape[0]
    prev1 = np.concatenate([[0], m[:-1]]) if n else m
    prev2 = np.concatenate([[0, 0], m[:-2]]) if n > 1 else np.zeros_like(m)
    return (prev2 << 8) | (prev1 << 4) | m


DEFAULT_START_CODONS = ("atg", "gtg", "ttg")
DEFAULT_STOP_CODONS = ("taa", "tag", "tga")
