"""ICM bank training in PyTorch tensor code on the reads' device.

Counterpart of ``glimmer_mg_tpu.ops.icm_train_device`` (reference
``ICM_Training_t``, src/ICM/icm.cc:1010-1462), which was XLA on the TPU:
every tree level is a batched histogram over packed context keys (an
integer ``index_add_``), followed by vectorised mutual-information position
selection and chi-square deleted interpolation. It trains a whole bank of
ICMs at once, one per cluster, from a read -> cluster assignment matrix:
the inner loop of Scimm's EM (``pipeline.scimm``).

Numerics. Counts are exact int64 sums, so they are the same on the CPU and
on the card in any order. The float math is f32 like the JAX package's,
written op for op as XLA compiles it for the CPU: sums over the 16 pair
terms and the 4 chi-square terms run left to right, a division by a
constant is a product with the constant's f32 reciprocal and ``(a / b) /
c`` is ``a / (b * c)`` (XLA's algebraic simplifier). So the mutual
information differs from the JAX package's only through ``log``, which is
each framework's own (XLA's CPU ``log`` is not correctly rounded), and the
probs also where XLA fuses the interpolation's last multiply-add into one
FMA. Where two ``log``s differ by an ulp, a mutual-information near-tie in
``_select_positions`` can pick another context position;
``icm_train_check.tie_nodes`` names such nodes when two trainings of the
same reads (the CPU's and the card's) are held to each other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.icm import num_tree_nodes
from ..parallel import mesh as pmesh

MUT_INFO_BIAS = 0.03
MUT_INFO_EPSILON = 1e-4
PSEUDO_COUNT = 0.001
SAMPLE_SIZE_BOUND = 400

CHI2_VAL = np.array([2.37, 4.11, 6.25, 7.81, 9.35, 11.3, 12.8], np.float32)
CHI2_SIG = np.array([0.50, 0.75, 0.90, 0.95, 0.975, 0.99, 0.995], np.float32)

# f32 reciprocals of the constant divisors, as XLA folds them
_INV_BIAS = np.float32(1.0) / np.float32(1.0 + MUT_INFO_BIAS)
_INV_SAMPLE = np.float32(1.0) / np.float32(SAMPLE_SIZE_BOUND)


def _window_fields(reads, lengths, model_len, periodicity):
    """Per-position packed context, final base, frame, validity. reads (B,L)."""
    b, l = reads.shape
    w = model_len - 1
    s = reads.to(torch.int32)
    padded = torch.cat([s.new_zeros((b, w)), s], dim=1)
    ctx = torch.zeros_like(s)
    for k in range(w):
        ctx = ctx | (padded[:, k:k + l] << (2 * k))
    i = torch.arange(l, device=reads.device)
    valid = (i[None, :] >= w) & (i[None, :] < lengths[:, None])
    frame = (i + 1) % periodicity  # (model_len + start) % p for this layout
    return ctx, s, frame[None, :].expand(b, l), valid


def _sum_last(x):
    """Sum over the last axis, left to right."""
    out = x[..., 0]
    for k in range(1, x.shape[-1]):
        out = out + x[..., k]
    return out


def _mi_terms(counts):
    """counts (..., W, 16) -> (the 16 terms p log(p / (left x right)) of
    each position's mutual information (..., W, 16), the totals (..., W));
    float32."""
    pair = counts.to(torch.float32).reshape(counts.shape[:-1] + (4, 4))
    total = _sum_last(pair.reshape(counts.shape))
    left = _sum_last(pair)
    right = _sum_last(pair.transpose(-1, -2))
    safe_t = torch.where(total == 0, 1.0, total)
    p = pair / safe_t[..., None, None]
    lp = left / safe_t[..., None]
    rp = right / safe_t[..., None]
    denom = lp[..., :, None] * rp[..., None, :]
    ok = (pair != 0) & (left[..., :, None] != 0) & (right[..., None, :] != 0)
    # p / denom as XLA simplifies (a / b) / c: a / (b * c)
    ratio = torch.where(
        ok, pair / (safe_t[..., None, None]
                    * torch.where(denom == 0, 1.0, denom)), 1.0)
    term = torch.where(ok, p * torch.log(ratio), 0.0)
    return term.reshape(counts.shape[:-1] + (16,)), total


def _mutual_info(counts):
    """counts (..., W, 16) -> MI (..., W); float32."""
    term, total = _mi_terms(counts)
    return torch.where(total == 0, 0.0, _sum_last(term))


def _select_positions(mi, sums, stop_check):
    """Sequential best-position scan with right bias (icm.cc:1125-1148)."""
    w = mi.shape[-1]
    best = mi[..., 0]
    max_pos = torch.zeros(best.shape, dtype=torch.int32, device=mi.device)
    for i in range(1, w):
        nxt = mi[..., i]
        ge = nxt >= best
        close = (~ge) & (nxt >= best * float(_INV_BIAS))
        best = torch.where(ge, nxt, best)
        max_pos = torch.where(ge | close, i, max_pos)
    if stop_check:
        stop = (best <= MUT_INFO_EPSILON) & (sums < SAMPLE_SIZE_BOUND)
        max_pos = torch.where(stop, -1, max_pos)
    return max_pos


def _interpolate(ct4, parent_prob):
    """Chi-square deleted interpolation (icm.cc:1260-1330), f32."""
    val = torch.from_numpy(CHI2_VAL).to(ct4.device)
    sig = torch.from_numpy(CHI2_SIG).to(ct4.device)
    ct = ct4.to(torch.float32)
    total = _sum_last(ct)
    prob = (ct + PSEUDO_COUNT * parent_prob) / (total + PSEUDO_COUNT)[..., None]

    expected = total[..., None] * parent_prob
    diff = ct - expected
    chi2 = _sum_last(torch.where(
        expected > 0,
        diff * diff / torch.where(expected > 0, expected, 1.0), 0.0))
    idx = torch.bucketize(chi2, val)  # searchsorted, side="left"
    n = val.shape[0]
    i = idx.clamp(1, n - 1)
    lam_mid = sig[i - 1] + (
        (chi2 - val[i - 1]) / (val[i] - val[i - 1])
    ) * (sig[i] - sig[i - 1])
    lam = torch.where(idx == 0, 0.0, torch.where(idx == n, 1.0, lam_mid))
    lam = torch.clamp(lam * total * float(_INV_SAMPLE), max=1.0)
    interp = prob * lam[..., None] + (1.0 - lam)[..., None] * parent_prob
    return torch.where((total < SAMPLE_SIZE_BOUND)[..., None], interp, prob)


def level_histogram(model, frame, ctx, last, node_local, valid, n_models,
                    periodicity, nodes_on_level, model_len):
    """(n_models, p, nodes_on_level, W, 16) int64 counts of (context base
    at window position j, final base) pairs: every flat position where
    ``valid`` adds one to its (model, frame, node, j, pair) bin."""
    w = model_len - 1
    size = n_models * periodicity * nodes_on_level * w * 16
    base = ((model * periodicity + frame) * nodes_on_level
            + node_local) * (w * 16)
    j = torch.arange(w, device=ctx.device)
    pair = 4 * ((ctx[valid, None] >> (2 * j)) & 3) + last[valid, None]
    key = base[valid, None] + j * 16 + pair  # (valid positions, W)
    counts = torch.bincount(key.reshape(-1), minlength=size)
    return counts.reshape(n_models, periodicity, nodes_on_level, w, 16)


def train_icm_bank(
    reads,  # (B, L) int base indices (padded)
    lengths,  # (B,) int
    assign,  # (B, n_models) float32 weights (one-hot for hard EM)
    n_models: int,
    model_len: int = 12,
    depth: int = 7,
    periodicity: int = 3,
    record: dict | None = None,
    data_group=None,
):
    """Train ``n_models`` ICMs from weighted reads on the reads' device;
    returns (mip (M, P, N) int32, probs (M, P, N, 4) f32 logged), zero
    probs logged as -FLT_MAX.

    Each read counts for the model its assignment row is largest in (the
    first on ties), if that weight is positive. With ``record`` (a dict),
    each level's mutual information (M, P, nodes, W) f32, the sum of its
    16 terms' magnitudes (M, P, nodes, W) f32 and the sample sizes (M, P,
    nodes) int64 are appended under ``"mi"``, ``"mag"`` and ``"sums"``,
    for ``icm_train_check.tie_nodes``.

    ``data_group``: a ``torch.distributed`` group whose ranks hold the
    other shards of the reads (the counterpart of the JAX package's
    ``data_axis``): each level's histogram is summed over it before the
    mutual information. The counts are exact integers, so every rank
    trains the bank that one rank holding all the reads would.
    """
    p = periodicity
    n_nodes = num_tree_nodes(depth)
    b, l = reads.shape
    dev = reads.device

    ctx, last, frame, valid = _window_fields(reads, lengths, model_len, p)
    # hard assignment index per read (EM uses one-hot); rows of zeros add 0
    model_of = torch.argmax(assign, dim=1)
    weight = assign[torch.arange(b, device=dev), model_of] > 0
    valid = valid & weight[:, None]

    mip = torch.zeros((n_models, p, n_nodes), dtype=torch.int32, device=dev)
    probs = torch.zeros((n_models, p, n_nodes, 4), dtype=torch.float32,
                        device=dev)

    flat_model = model_of[:, None].expand(b, l).reshape(-1)
    flat_frame = frame.reshape(-1)
    flat_ctx = ctx.reshape(-1)
    flat_last = last.reshape(-1).to(torch.int64)
    flat_valid = valid.reshape(-1)

    def level_counts(node_local, nodes_on_level, level_valid):
        counts = level_histogram(flat_model, flat_frame, flat_ctx, flat_last,
                                 node_local, level_valid, n_models, p,
                                 nodes_on_level, model_len)
        return pmesh.all_reduce_sum(counts, data_group)

    def keep(counts, mi, sums):
        if record is not None:
            record.setdefault("mi", []).append(mi)
            record.setdefault("mag", []).append(
                _mi_terms(counts)[0].abs().sum(-1))
            record.setdefault("sums", []).append(sums)

    # ---- root ----
    zero = torch.zeros_like(flat_frame)
    root_counts = level_counts(zero, 1, flat_valid)[:, :, 0]
    sums = root_counts[..., 0, :].sum(-1)
    final_ct = root_counts[..., 0, :].reshape(n_models, p, 4, 4).sum(-2)
    probs[:, :, 0, :] = (
        (final_ct.to(torch.float32) + np.float32(PSEUDO_COUNT / 4))
        / (sums[..., None].to(torch.float32) + np.float32(PSEUDO_COUNT)))
    mi = _mutual_info(root_counts)
    keep(root_counts[:, :, None], mi[:, :, None], sums[:, :, None])
    mip[:, :, 0] = _select_positions(mi, sums, stop_check=False)

    # ---- levels ----
    first_node = 1
    nodes_on_level = 4
    for level in range(1, depth + 1):
        node = zero
        ok = flat_valid
        for _ in range(level):
            pos = mip[flat_model, flat_frame, node]
            ok = ok & (pos >= 0)
            bb = (flat_ctx >> (2 * pos.clamp(min=0))) & 3
            node = torch.where(ok, 4 * node + bb + 1, node)
        local = (node - first_node).clamp(0, nodes_on_level - 1)
        counts = level_counts(local, nodes_on_level, ok)

        lvl_nodes = first_node + torch.arange(nodes_on_level, device=dev)
        parents = (lvl_nodes - 1) // 4
        parent_alive = mip[:, :, parents] >= 0
        sums = counts[..., 0, :].sum(-1)
        final_ct = counts[..., 0, :].reshape(
            n_models, p, nodes_on_level, 4, 4).sum(-2)
        mi = _mutual_info(counts)
        keep(counts, mi, sums)
        max_pos = _select_positions(mi, sums, stop_check=True)
        mip[:, :, lvl_nodes] = torch.where(parent_alive, max_pos, -2)
        new_probs = _interpolate(final_ct, probs[:, :, parents, :])
        probs[:, :, lvl_nodes, :] = torch.where(parent_alive[..., None],
                                                new_probs, 0.0)
        first_node += nodes_on_level
        nodes_on_level *= 4

    fmax = torch.finfo(torch.float32).max
    logged = torch.where(probs > 0,
                         torch.log(torch.where(probs > 0, probs, 1.0)), -fmax)
    return mip, logged

