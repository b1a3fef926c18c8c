# Frozen copy of glimmer_mg_torch/io/features_file.py at commit ab5a5d3.
""".features.txt parsing → feature models.

Reference: Parse_Features (glimmer_base.cc:1197-1323), Read_Start_Dist
(2421-2460), Read_Length_Dist (2264-2358), Read_Orient_Dist (2361-2418),
Read_Dist_Dist (2216-2261), AdjDist_Smooth (298-331), Blend_Length
(334-420), and Length_Dist_t/Start_Dist_t/AdjOr_Dist_t/AdjDist_Dist_t
Make_Log_Odds (gene.cc:539-925).

Float32/float64 behavior mirrors the C exactly: histograms live in float32
vectors with float accumulation where the reference uses vector<float>, and
in float64 where it uses vector<double>.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..models import features as feat
from ..utils import mathutils as mu

MAX_LENGTH = 2000  # Read_Length_Dist const
LENGTH_SIGMA = 20.0
PAR_CUMPROB = 0.25
MAX_DIST = 1000  # Read_Dist_Dist const
DIST_PSEUDO = 0.25
OLAP_SIGMA = 20.0
POS_SIGMA = 30.0


@dataclasses.dataclass
class ParsedFeatures:
    logodds_length: feat.LengthDist | None
    logodds_start: feat.StartDist | None
    logodds_adj_or: feat.AdjOrDist | None
    logodds_adj_dist: feat.AdjDistDist | None
    logodds_prior: np.float32 | None  # replaces -u prior when counts present
    user_length: bool
    user_start: bool
    user_adj: bool


def _read_pairs(lines_iter):
    """Consume 2-token lines until a non-matching line; returns (pairs, n)."""
    pairs = []
    for line in lines_iter:
        toks = line.split()
        if len(toks) == 2:
            pairs.append(toks)
        else:
            break
    return pairs


def read_start_dist(lines_iter) -> np.ndarray:
    dist = np.zeros(3, dtype=np.float32)
    codes = {"ATG": 0, "GTG": 1, "TTG": 2}
    for toks in _read_pairs(lines_iter):
        dist[codes[toks[0].upper()]] = int(toks[1])
    dist = (dist.astype(np.float64) + 1.0).astype(np.float32)
    s = mu.f32_sequential_sum(dist)
    return (dist / s).astype(np.float32)


def read_orient_dist(lines_iter) -> np.ndarray:
    dist = np.zeros(4, dtype=np.float32)
    keymap = {("1", "1"): 0, ("1", "-1"): 1, ("-1", "1"): 2, ("-1", "-1"): 3}
    for toks in _read_pairs(lines_iter):
        ors = tuple(toks[0].split(","))
        dist[keymap[ors]] = int(toks[1])
    dist = (dist.astype(np.float64) + 1.0).astype(np.float32)
    s = mu.f32_sequential_sum(dist)
    return (dist / s).astype(np.float32)


def read_length_dist(lines_iter, min_gene_len: int):
    """Returns (log-prob f64 array of MAX_LENGTH, total_count f32)."""
    min_aa_len = int(math.ceil(np.float32(min_gene_len) / 3.0))
    nonpar = np.zeros(MAX_LENGTH, dtype=np.float64)
    for toks in _read_pairs(lines_iter):
        length = int(toks[0])
        count = int(toks[1])
        if length + 1 > len(nonpar):
            nonpar = np.concatenate([nonpar, np.zeros(length + 1 - len(nonpar))])
        nonpar[length] = count

    # total gene/orf count: float accumulation over l in [min_aa, MAX_LENGTH)
    total_count = np.float32(0.0)
    for l in range(min_aa_len, MAX_LENGTH):
        total_count = np.float32(total_count + np.float32(nonpar[l]))

    k, theta = mu.gamma_ml(nonpar)
    par = np.empty(MAX_LENGTH, dtype=np.float64)
    denom = k * math.log(theta) + math.lgamma(k)
    with np.errstate(divide="ignore"):
        l_arr = np.arange(MAX_LENGTH, dtype=np.float64)
        par = (k - 1) * np.log(l_arr) - l_arr / theta - denom
    mu.log_normalize(par, min_aa_len)

    nonpar = mu.kernel_smooth(nonpar, LENGTH_SIGMA, MAX_LENGTH)
    mu.normalize(nonpar, min_aa_len)
    nonpar = nonpar[:MAX_LENGTH].copy()
    with np.errstate(divide="ignore"):
        nonpar[min_aa_len:] = np.log(nonpar[min_aa_len:])

    blended = _blend_length(par, nonpar, PAR_CUMPROB, min_aa_len, min_gene_len)
    return blended, total_count


def _blend_length(par, nonpar, par_cumprob, min_aa_len, min_gene_len):
    """Blend_Length (glimmer_base.cc:334-420)."""
    size = len(nonpar)
    out = np.zeros(size, dtype=np.float64)

    tmp = 0.0
    blend_lower = min_aa_len
    while blend_lower < size and tmp < par_cumprob:
        tmp += math.exp(nonpar[blend_lower])
        blend_lower += 1
    tmp = 0.0
    blend_upper = size - 1
    while blend_upper > 0 and tmp < par_cumprob:
        tmp += math.exp(nonpar[blend_upper])
        blend_upper -= 1
    if blend_lower == size or blend_upper == 0:
        raise ValueError("could not find quartiles of nonparametric length dist")

    l = min_aa_len
    while l < blend_lower:
        out[l] = nonpar[l]
        l += 1
    blend_dist = float(blend_upper) - float(blend_lower)
    while l <= blend_upper:
        coeff = (float(l) - float(blend_lower)) / blend_dist
        out[l] = mu.coeff_log_add(par[l], nonpar[l], coeff)
        l += 1
    while l < size:
        out[l] = par[l]
        l += 1
    mu.log_normalize(out, min_aa_len)
    return out


def read_dist_dist(lines_iter, max_olap_bases: int):
    """Read_Dist_Dist (glimmer_base.cc:2216). Returns (f32 array, DMO)."""
    pairs = _read_pairs(lines_iter)
    dist_max_overlap = -int(pairs[0][0])
    if dist_max_overlap != max_olap_bases:
        raise ValueError(
            f"feature file max overlap {dist_max_overlap} != {max_olap_bases}"
        )
    vals = [np.float32(float(t[1])) for t in pairs]
    dist = np.zeros(dist_max_overlap + MAX_DIST, dtype=np.float32)
    dist[: len(vals)] = vals[: len(dist)]
    dist = (dist.astype(np.float64) + DIST_PSEUDO).astype(np.float32)
    dist = _adjdist_smooth(dist, dist_max_overlap)
    s = mu.f32_sequential_sum(dist)
    return (dist / s).astype(np.float32), dist_max_overlap


def _adjdist_smooth(dists: np.ndarray, dist_max_overlap: int) -> np.ndarray:
    """AdjDist_Smooth (glimmer_base.cc:298-331)."""
    out = dists.copy()
    for ph in range(3):
        sel = np.arange(ph, dist_max_overlap - 5, 3)
        if len(sel):
            out[sel] = mu.kernel_smooth_f32(out[sel], OLAP_SIGMA)
    pos = out[dist_max_overlap:]
    out[dist_max_overlap:] = mu.kernel_smooth_f32(pos, POS_SIGMA)
    return out


def _length_make_log_odds(gene_l, non_l, frag_lengths, min_gene_len):
    """Length_Dist_t::Make_Log_Odds (gene.cc:539-617)."""
    ld = feat.LengthDist()
    short_multiplier = 2.0
    ld.min_aa_len = int(math.ceil(np.float32(min_gene_len) / 3.0))
    max_length = len(gene_l)

    # Choose_Frags (gene.cc:395-425): note the reference tracks BOTH
    # min_len and max_len with `<`, so both end up the minimum and a single
    # fragment distribution results — replicated faithfully.
    min_len = frag_lengths[0]
    max_len = frag_lengths[0]
    for fl in frag_lengths:
        if fl < min_len:
            min_len = fl
        if fl < max_len:
            max_len = fl
    min_map = feat.LengthDist.map_length(min_len)
    max_map = feat.LengthDist.map_length(max_len)
    ld.fragment_lengths = []
    my_len = min_map
    while my_len <= max_map:
        ld.fragment_lengths.append(my_len)
        my_len += 20.0
    n_frags = len(ld.fragment_lengths)

    ld.full = []
    ld.trunc = []
    ld.trunc2 = []
    ld.full_trunc_merge = [ld.min_aa_len] * max(3, n_frags)
    l_min = float(ld.min_aa_len)

    try:
        from ..native import get_lib

        native_lib = get_lib()
    except Exception:
        native_lib = None

    gene_l64 = np.ascontiguousarray(gene_l, dtype=np.float64)
    non_l64 = np.ascontiguousarray(non_l, dtype=np.float64)

    for d in range(n_frags):
        frag = ld.fragment_lengths[d]
        # full table: elementwise, bitwise-equal vectorization of the scalar loop
        full = gene_l64 - non_l64
        neg = full < 0
        full[neg] *= short_multiplier
        full[: ld.min_aa_len] = -44.0

        trunc = np.zeros(max_length, dtype=np.float64)
        trunc2 = np.zeros(max_length, dtype=np.float64)
        if native_lib is not None:
            # exact C++ mirror of the scan below (gmg_length_trunc_scan)
            native_lib.gmg_length_trunc_scan(
                gene_l64.ctypes.data, non_l64.ctypes.data, max_length,
                ld.min_aa_len, float(frag), l_min,
                trunc.ctypes.data, trunc2.ctypes.data,
            )
        else:
            def safe_log(x):
                # C log(): log(0) = -inf (no exception), log(<0) = nan
                if x > 0.0:
                    return math.log(x)
                return -math.inf if x == 0.0 else math.nan

            g_cum = n_cum = -math.inf
            g_cum2 = n_cum2 = -math.inf
            for l in range(max_length - 1, ld.min_aa_len - 1, -1):
                if l > frag:
                    w = safe_log((frag - l_min) / (float(l) + frag - 2.0 * l_min))
                else:
                    w = safe_log((float(l) - l_min) / (float(l) + frag - 2.0 * l_min))
                g_cum = mu.log_add(g_cum, gene_l[l] + w)
                n_cum = mu.log_add(n_cum, non_l[l] + w)
                if l > frag:
                    w2 = safe_log((float(l) - frag) / (float(l) + frag - 2.0 * l_min))
                    g_cum2 = mu.log_add(g_cum2, gene_l[l] + w2)
                    n_cum2 = mu.log_add(n_cum2, non_l[l] + w2)
                trunc[l] = g_cum - n_cum
                trunc2[l] = g_cum2 - n_cum2

        merge = ld.min_aa_len
        while full[merge] < 0.0:
            merge += 1
        ld.full_trunc_merge[d] = merge
        ld.full.append(full)
        ld.trunc.append(trunc)
        ld.trunc2.append(trunc2)
    return ld


def parse_features(
    path,
    min_gene_len: int = 75,
    max_olap_bases: int = 50,
    sequence_aa_lengths=None,
    logodds_fudge: float | None = None,
) -> ParsedFeatures:
    """Parse a .features.txt file into feature model objects.

    ``sequence_aa_lengths``: Get_Sequence_Lengths (seq len // 3 per input
    sequence) — required when the file carries LENGTH distributions.
    """
    with open(path) as fh:
        lines = iter(fh.read().splitlines())

    gene_count = np.float32(0.0)
    non_count = np.float32(0.0)
    length_gene = length_non = None
    start_gene = start_non = None
    adjor_gene = adjor_non = None
    adj = {}

    for line in lines:
        if not line.startswith("DIST"):
            continue
        toks = line.split()
        if len(toks) != 3:
            raise ValueError(f"bad DIST line: {line}")
        dist_type = toks[1].upper()
        orf_type = toks[2].upper()
        is_gene = orf_type == "GENE"
        if dist_type == "START":
            if is_gene:
                start_gene = read_start_dist(lines)
            else:
                start_non = read_start_dist(lines)
        elif dist_type == "LENGTH":
            if is_gene:
                length_gene, gene_count = read_length_dist(lines, min_gene_len)
            else:
                length_non, non_count = read_length_dist(lines, min_gene_len)
        elif dist_type == "ADJACENT_ORIENTATION":
            if is_gene:
                adjor_gene = read_orient_dist(lines)
            else:
                adjor_non = read_orient_dist(lines)
        elif dist_type.startswith("ADJACENT_DISTANCE"):
            key = dist_type[len("ADJACENT_DISTANCE_"):]
            d, _ = read_dist_dist(lines, max_olap_bases)
            adj[(key, orf_type)] = d
        else:
            raise ValueError(f"unknown DIST type {dist_type}")

    out = ParsedFeatures(None, None, None, None, None, False, False, False)

    if gene_count > 0 and non_count > 0:
        if sequence_aa_lengths is None:
            raise ValueError("sequence lengths required for LENGTH features")
        fudge = np.float32(1.0 if logodds_fudge is None else logodds_fudge)
        out.logodds_prior = np.float32(
            float(fudge) + math.log(float(np.float32(gene_count / non_count)))
        )
        out.logodds_length = _length_make_log_odds(
            length_gene, length_non, list(sequence_aa_lengths), min_gene_len
        )
        out.user_length = True

    if start_gene is not None:
        sd = feat.StartDist()
        sd.make_log_odds(start_gene, start_non)
        out.logodds_start = sd
        out.user_start = True

    if adjor_gene is not None:
        ao = feat.AdjOrDist()
        ao.make_log_odds(adjor_gene, adjor_non)
        out.logodds_adj_or = ao

        ad = feat.AdjDistDist()
        ad.max_overlap = max_olap_bases
        for key, attr in (("1_1", "ff"), ("1_-1", "fr"), ("-1_1", "rf")):
            ad.make_log_odds(attr, adj.get((key, "GENE")), adj.get((key, "NON")))
        out.logodds_adj_dist = ad
        out.user_adj = True

    return out
