# Frozen copy of glimmer_mg_torch/models/icm_train.py at commit ab5a5d3.
"""ICM training: windowed context counting + chi-square deleted interpolation.

Reimplements the reference trainer (``ICM_Training_t``, src/ICM/icm.cc:1010-1462)
as vectorized histogram reductions:

  * All training windows of all strings are enumerated once; each window is a
    packed 2-bit context integer + final base + frame
    (frame = (model_len + start) % periodicity, matching both the root's
    strided per-frame counting, icm.cc:1377-1399, and the level counting of
    ``Count_Char_Pairs_Restricted``, icm.cc:1190-1229).
  * Per tree level, windows are attributed to nodes by the same masked walk
    used for scoring, and (position, base-pair) counts fall out of one
    ``np.bincount`` per context position.
  * Mutual-information position selection with the right-preference bias
    (icm.cc:1125-1148) and chi-square deleted interpolation with the parent
    (``Interpolate_Probs``, icm.cc:1260-1330) are vectorized per level.

Precision notes (for parity with the C++): root probabilities are computed in
float32 (icm.cc:1410-1413 uses float arithmetic); interpolation is computed
in float64 but stores through float32 at each assignment, exactly as the
C code's double-computed / float-stored expressions do. Probabilities match
reference-built models to <= 1 ulp; tree structure (mut_info_pos) matches
exactly (verified against build-icm output in tests).
"""

from __future__ import annotations

import numpy as np

from .icm import ICM, num_tree_nodes

MUT_INFO_BIAS = 0.03
MUT_INFO_EPSILON = 1e-4
PSEUDO_COUNT = 0.001
SAMPLE_SIZE_BOUND = 400
FLT_MAX = np.float32(np.finfo(np.float32).max)

# The reference tables are float constants promoted to double in expressions
# (icm.hh:36-40); mirror that by storing float32 then widening.
CHI2_VAL = np.array([2.37, 4.11, 6.25, 7.81, 9.35, 11.3, 12.8], np.float32).astype(np.float64)
CHI2_SIGNIFICANCE = np.array([0.50, 0.75, 0.90, 0.95, 0.975, 0.99, 0.995], np.float32).astype(np.float64)


def _window_arrays(seqs_idx, model_len: int, periodicity: int):
    """Enumerate every complete window of every string.

    Returns (ctx, last, frame): packed context (int64, 2 bits per window
    position 0..model_len-2), final base, and the model frame that scores the
    window's final base.
    """
    w = model_len - 1
    ctxs, lasts, frames = [], [], []
    for s in seqs_idx:
        s = np.asarray(s, dtype=np.int64)
        n = len(s)
        if n < model_len:
            continue
        n_win = n - model_len + 1
        ctx = np.zeros(n_win, dtype=np.int64)
        for k in range(w):
            ctx |= s[k : k + n_win] << (2 * k)
        ctxs.append(ctx)
        lasts.append(s[w:])
        frames.append((model_len + np.arange(n_win)) % periodicity)
    if not ctxs:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z
    return (
        np.concatenate(ctxs),
        np.concatenate(lasts),
        np.concatenate(frames).astype(np.int64),
    )


def _mutual_info(counts: np.ndarray) -> np.ndarray:
    """Mutual information per (…, 16) pair-count vector (icm.cc:1900)."""
    ct = counts.astype(np.float64)
    pair = ct.reshape(ct.shape[:-1] + (4, 4))
    total = pair.sum(axis=(-1, -2))  # integer-valued, exact
    left = pair.sum(axis=-1)  # (…, 4)
    right = pair.sum(axis=-2)
    with np.errstate(divide="ignore", invalid="ignore"):
        safe_total = np.where(total == 0, 1.0, total)
        p = pair / safe_total[..., None, None]
        lp = left / safe_total[..., None]
        rp = right / safe_total[..., None]
        denom = lp[..., :, None] * rp[..., None, :]
        term = np.where(
            (pair != 0) & (left[..., :, None] != 0) & (right[..., None, :] != 0),
            p * np.log(np.where(denom > 0, p / np.where(denom == 0, 1, denom), 1.0)),
            0.0,
        )
    mi = term.reshape(ct.shape[:-1] + (16,)).sum(axis=-1)
    return np.where(total == 0, 0.0, mi)


def _select_positions(mi: np.ndarray, sums: np.ndarray, stop_check: bool):
    """Vectorized max-mutual-information position selection with right bias.

    ``mi``: (…, W) mutual information per context position. Implements the
    sequential scan of icm.cc:1125-1148: track best; a later position also
    captures max_pos when within best/(1+MUT_INFO_BIAS).
    Returns (max_pos, used_info, best_info).
    """
    w = mi.shape[-1]
    best = mi[..., 0].copy()
    used = mi[..., 0].copy()
    max_pos = np.zeros(best.shape, dtype=np.int64)
    for i in range(1, w):
        nxt = mi[..., i]
        ge = nxt >= best
        close = ~ge & (nxt >= best / (1.0 + MUT_INFO_BIAS))
        best = np.where(ge, nxt, best)
        used = np.where(ge | close, nxt, used)
        max_pos = np.where(ge | close, i, max_pos)
    if stop_check:
        stop = (best <= MUT_INFO_EPSILON) & (sums < SAMPLE_SIZE_BOUND)
        max_pos = np.where(stop, -1, max_pos)
    return max_pos, used, best


def _interpolate_probs(ct4: np.ndarray, parent_prob: np.ndarray) -> np.ndarray:
    """Vectorized Interpolate_Probs (icm.cc:1260-1330).

    ``ct4``: (…, 4) integer final-char counts; ``parent_prob``: (…, 4) f32.
    Returns float32 (…, 4) probabilities.
    """
    ct = ct4.astype(np.float64)
    parent = parent_prob.astype(np.float64)
    total = ct.sum(axis=-1)  # exact

    prob = ((ct + PSEUDO_COUNT * parent) / (total + PSEUDO_COUNT)[..., None]).astype(
        np.float32
    )

    small = total < SAMPLE_SIZE_BOUND
    if not small.any():
        return prob

    expected = total[..., None] * parent
    with np.errstate(divide="ignore", invalid="ignore"):
        chi2_terms = np.where(
            expected > 0.0, (ct - expected) ** 2 / np.where(expected > 0, expected, 1), 0.0
        )
    chi2 = chi2_terms.sum(axis=-1)

    # table search: first index with CHI2_VAL[i] >= chi2 (i may be 7)
    idx = np.searchsorted(CHI2_VAL, chi2, side="left")
    # C loop condition is CHI2_VAL[i] < chi2_stat (strict), so equal values
    # stop — matching searchsorted 'left'.
    lam = np.empty(chi2.shape, dtype=np.float64)
    lam[idx == 0] = 0.0
    lam[idx == len(CHI2_VAL)] = 1.0
    mid = (idx > 0) & (idx < len(CHI2_VAL))
    if mid.any():
        i = idx[mid]
        lam[mid] = CHI2_SIGNIFICANCE[i - 1] + (
            (chi2[mid] - CHI2_VAL[i - 1]) / (CHI2_VAL[i] - CHI2_VAL[i - 1])
        ) * (CHI2_SIGNIFICANCE[i] - CHI2_SIGNIFICANCE[i - 1])

    lam = lam * (total / SAMPLE_SIZE_BOUND)
    lam = np.minimum(lam, 1.0)

    # Two float-stored assignments like the C code (icm.cc:1322-1327):
    #   prob *= lambda  (double product, float store)
    #   prob += (1 - lambda) * parent  (double sum, float store)
    p1 = (prob.astype(np.float64) * lam[..., None]).astype(np.float32)
    p2 = (p1.astype(np.float64) + (1.0 - lam)[..., None] * parent).astype(np.float32)
    return np.where(small[..., None], p2, prob).astype(np.float32)


def train_icm(
    seqs,
    model_len: int = 12,
    depth: int = 7,
    periodicity: int = 3,
) -> ICM:
    """Train an ICM from encoded sequences (arrays of base indices 0..3).

    Equivalent to ``build-icm`` with the given window/depth/period; callers
    are responsible for pre-reversing strings (-r) or dropping in-frame-stop
    strings (-F) — see ``pipeline`` helpers.
    """
    n_nodes = num_tree_nodes(depth)
    p = periodicity
    w = model_len - 1
    icm = ICM.empty(model_len, depth, p)
    mut_info = np.zeros((p, n_nodes), dtype=np.float32)

    ctx, last, frame = _window_arrays(seqs, model_len, p)
    n_win = len(ctx)
    if n_win == 0:
        raise ValueError("no training windows (all strings shorter than model_len)")

    # ---- root (icm.cc:1356-1455) ----
    if depth == 0:
        counts = np.zeros((p, 4), dtype=np.int64)
        np.add.at(counts, (frame, last), 1)
        sums = counts.sum(axis=-1)
        # icm.cc:1390-1392: float numerator, DOUBLE denominator (no float
        # cast there, unlike the depth>0 branch), double division, f32 store.
        num = (counts.astype(np.float32) + np.float32(PSEUDO_COUNT / 4)).astype(
            np.float64
        )
        icm.probs[:, 0, :] = (num / (sums[:, None] + PSEUDO_COUNT)).astype(np.float32)
        icm.mip[:, 0] = -1
        _take_logs(icm)
        return icm

    # Pair counts at the root: (p, W, 16)
    root_counts = np.zeros((p, w, 16), dtype=np.int64)
    for j in range(w):
        pair = 4 * ((ctx >> (2 * j)) & 3) + last
        key = frame * 16 + pair
        binned = np.bincount(key, minlength=p * 16).reshape(p, 16)
        root_counts[:, j, :] = binned
    sums = root_counts[:, 0, :].sum(axis=-1)  # same for any j
    final_ct = root_counts[:, 0, :].reshape(p, 4, 4).sum(axis=1)  # count of last char

    # float arithmetic exactly as icm.cc:1410-1413
    icm.probs[:, 0, :] = (
        final_ct.astype(np.float32) + np.float32(PSEUDO_COUNT / 4)
    ) / (sums[:, None] + PSEUDO_COUNT).astype(np.float32)

    mi = _mutual_info(root_counts)  # (p, W)
    max_pos, used, best = _select_positions(mi, sums, stop_check=False)
    # Root stores best_info, and max_pos from the biased scan where `used`
    # tracking is absent (icm.cc:1415-1439 keeps best only).
    icm.mip[:, 0] = max_pos.astype(np.int16)
    mut_info[:, 0] = best.astype(np.float32)

    # ---- levels 1..depth (Complete_Tree, icm.cc:1061-1186) ----
    mip_i64 = np.full((p, n_nodes), 0, dtype=np.int64)  # working copy
    mip_i64[:, 0] = icm.mip[:, 0]

    first_node = 1
    nodes_on_level = 4
    for level in range(1, depth + 1):
        # Attribute each window to its level-`level` node by walking the tree.
        node = np.zeros(n_win, dtype=np.int64)
        valid = np.ones(n_win, dtype=bool)
        for _ in range(level):
            pos = mip_i64[frame, node]
            valid &= pos >= 0
            b = (ctx >> (2 * np.maximum(pos, 0))) & 3
            node = np.where(valid, 4 * node + b + 1, node)

        local = node - first_node  # level-local node index for valid windows
        counts = np.zeros((p, nodes_on_level, w, 16), dtype=np.int64)
        vf, vl, vc, vlast = frame[valid], local[valid], ctx[valid], last[valid]
        base_key = (vf * nodes_on_level + vl) * 16
        for j in range(w):
            pair = 4 * ((vc >> (2 * j)) & 3) + vlast
            binned = np.bincount(base_key + pair, minlength=p * nodes_on_level * 16)
            counts[:, :, j, :] = binned.reshape(p, nodes_on_level, 16)

        lvl_nodes = np.arange(first_node, first_node + nodes_on_level)
        parents = (lvl_nodes - 1) // 4
        parent_alive = mip_i64[:, parents] >= 0  # (p, nodes_on_level)

        sums = counts[:, :, 0, :].sum(axis=-1)
        final_ct = counts[:, :, 0, :].reshape(p, nodes_on_level, 4, 4).sum(axis=2)

        mi = _mutual_info(counts)  # (p, nodes_on_level, W)
        max_pos, used, best = _select_positions(mi, sums, stop_check=True)

        new_mip = np.where(parent_alive, max_pos, -2)
        mip_i64[:, lvl_nodes] = new_mip
        icm.mip[:, lvl_nodes] = new_mip.astype(np.int16)
        mut_info[:, lvl_nodes] = np.where(parent_alive, used, 0.0).astype(np.float32)

        probs = _interpolate_probs(final_ct, icm.probs[:, parents, :])
        icm.probs[:, lvl_nodes, :] = np.where(
            parent_alive[..., None], probs, 0.0
        ).astype(np.float32)

        first_node += nodes_on_level
        nodes_on_level *= 4

    _take_logs(icm)
    icm_mut_info = mut_info  # kept for ascii dumps later
    icm.mut_info = icm_mut_info  # type: ignore[attr-defined]
    return icm


def _take_logs(icm: ICM) -> None:
    """icm.cc:1334-1352: log of positive probs, else -FLT_MAX."""
    pos = icm.probs > 0.0
    with np.errstate(divide="ignore"):
        logged = np.log(icm.probs.astype(np.float64)).astype(np.float32)
    icm.probs = np.where(pos, logged, -FLT_MAX).astype(np.float32)


# ---------------------------------------------------------------------------
# build-icm front-end helpers
# ---------------------------------------------------------------------------


def prepare_training_strings(
    strings,
    reverse: bool = False,
    skip_in_frame_stops: bool = False,
    stop_codons=("taa", "tag", "tga"),
):
    """Apply build-icm's -F then -r preprocessing (build-icm.cc:78-118)."""
    out = []
    for s in strings:
        s = s.lower()
        if skip_in_frame_stops:
            if any(s[j : j + 3] in stop_codons for j in range(0, len(s) - 2, 3)):
                continue
        if reverse:
            s = s[::-1]
        out.append(s)
    return out
