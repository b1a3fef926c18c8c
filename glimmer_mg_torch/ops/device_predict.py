"""Device-resident per-read gene prediction: bank tables and batch entry.

PyTorch counterpart of ``glimmer_mg_tpu.ops.device_predict`` for the
error-free and the substitution mode, with or without per-base qualities
(no indel branching, linear reads, truncated ORFs allowed, default start
codons). The six-frame ICM
log-probs come from ``ops.icm_cuda`` and stay on the device; the ORF and
start-candidate frontend and event assembly run as one launch of KF
(``ops.frontend_cuda``) in either mode, the qualities handed to it in
the substitution mode (on CPU tensors, as the plain ``ops.frontend``),
the windowed event-graph DP and the traceback as one
launch of K3 (``ops.event_dp_cuda``; on CPU tensors its plain version,
``ops.event_dp``), and only gene records come back to the host.

Numerics follow the JAX package: event scores are carried in f64 by
default (``f64=False`` selects the f32 carry, every f64 table and sum
then becomes f32), DP candidates are compared in f32. Prefix sums add in
the JAX reference's order; ``log`` is PyTorch's, so scores may differ
from the host engine in the last ulps; coordinates, ids and printed
``%8.2f`` scores are the acceptance rule.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import observe
from . import icm_score

BIG = 1 << 29
F32 = torch.float32

# Padded event/gene capacities; overflowing reads are flagged per read and
# served by the host engine.
MAX_EVENTS = 160
MAX_GENES = 48

# Event type codes (engine.events: INITIAL=0 .. TERMINAL=5)
E_FWD_START, E_FWD_STOP, E_REV_START, E_REV_STOP = 1, 2, 3, 4

# Quality -> base-call probability table for Pass_Stop_Penalty
# (glimmer-mg.cc:961: p = 1 - 10^(-q/10)), built with Python pow so the
# entries equal the host engine's floats. Index 255 is the sentinel of
# rows without a quality file and holds the default 0.999.
_CP_TAB = np.array(
    [1.0 - 10.0 ** (-q / 10.0) for q in range(255)] + [0.999],
    dtype=np.float64,
)


# ---------------------------------------------------------------------------
# Bank construction (host, numpy)
# ---------------------------------------------------------------------------


def _codon_tables(patterns):
    """(65,)-entry can/must/which tables over pure 2-bit codons.

    Index = 16*b0 + 4*b1 + b2 (b0 = first base); index 64 = the
    partial-codon sentinel (always false / -1).
    """
    from ..models import dna

    masks_of = np.array([1, 2, 4, 8], dtype=np.int32)
    codes = np.arange(64)
    b0, b1, b2 = codes // 16, (codes // 4) % 4, codes % 4
    cod12 = (
        (masks_of[b0] << 8) | (masks_of[b1] << 4) | masks_of[b2]
    ).astype(np.int32)

    def can(pats):
        out = np.zeros(65, dtype=bool)
        out[:64] = dna.can_be(cod12, pats)
        return out

    def must(pats):
        out = np.zeros(65, dtype=bool)
        out[:64] = dna.must_be(cod12, pats)
        return out

    def which(pats):
        w = np.full(65, -1, dtype=np.int8)
        for pi in range(len(pats) - 1, -1, -1):
            w[:64][dna.can_be(cod12, pats[pi : pi + 1])] = pi
        return w

    return {
        "fwd_start": can(patterns.fwd_start),
        "rev_start": can(patterns.rev_start),
        "fwd_stop": must(patterns.fwd_stop),
        "rev_stop": must(patterns.rev_stop),
        "which_fwd": which(patterns.fwd_start),
        "which_rev": which(patterns.rev_start),
    }


@dataclasses.dataclass
class DeviceBank:
    """Stacked per-group model tables (numpy, host-built)."""

    # ICM bank (the six-frame walk's tables)
    gene_mip: np.ndarray
    gene_probs: np.ndarray
    indep_mip: np.ndarray
    indep_probs: np.ndarray
    model_len: int
    depth: int
    periodicity: int
    # codon tables (G, 65)
    fwd_start: np.ndarray
    rev_start: np.ndarray
    fwd_stop: np.ndarray
    rev_stop: np.ndarray
    which_fwd: np.ndarray
    which_rev: np.ndarray
    # feature tables
    prior: np.ndarray  # (G,) f32
    start_lo: np.ndarray  # (G, S) f32
    len_score: np.ndarray  # (G, 3, T) f64: rows = (full, 5'or3'-trunc, both)
    adj_or: np.ndarray  # (G, 4) f32: ff, fr, rf, rr
    adj_dist: np.ndarray  # (G, 3, D) f32: ff, fr, rf (padded; saturate=last)
    adj_dist_len: np.ndarray  # (G, 3) int32 true lengths
    ignore_score_len: np.ndarray  # (G,) int32
    # RBS mixture (PWM_Meta) or user log-odds PWM
    pwm_cols: np.ndarray  # (G, C, W, 4) f64 raw-prob mixture columns
    pwm_n: np.ndarray  # (G,) int32 — 0 = no PWM for this group
    pwm_user: np.ndarray  # (G, W, 4) f64 log-odds (user -b PWM) or zeros
    pwm_is_user: np.ndarray  # (G,) bool
    gc_lp: np.ndarray  # (G, 4) f64 background logs
    # scalars (uniform across the chunk; enforced by the builder)
    min_gene_len: int
    max_olap: int
    event_threshold: float
    start_threshold: float
    ribosome_window: int
    pwm_w: int


def build_bank(models_list, max_read_len: int) -> DeviceBank:
    """Stack a chunk's Models bundles into device tables.

    Raises ValueError when the bundles cannot share one batch (mixed
    scalars/model shapes); callers route those reads to the host engine.
    """
    m0 = models_list[0]
    for m in models_list:
        if (
            m.min_gene_len != m0.min_gene_len
            or m.max_olap_bases != m0.max_olap_bases
            or m.event_threshold != m0.event_threshold
            or m.start_threshold != m0.start_threshold
            or m.ribosome_window_size != m0.ribosome_window_size
            or m.gene_icm.model_len != m0.gene_icm.model_len
            or m.gene_icm.periodicity != m0.gene_icm.periodicity
            or m.circular
            or not m.allow_truncated_orfs
        ):
            raise ValueError("device path needs uniform scalar models")
    if m0.min_gene_len <= m0.max_olap_bases + 3:
        # the DP's bounded disqualify/requalify walks need an acyclic
        # best_pred graph, which holds when min_gene_len > max_olap + 3
        raise ValueError("device path needs min_gene_len > max_olap + 3")

    gmip, gprobs = icm_score.stack_bank([m.gene_icm for m in models_list])
    imip, iprobs = icm_score.stack_bank([m.indep_model for m in models_list])

    g = len(models_list)
    ct = [_codon_tables(m.patterns) for m in models_list]
    n_start = max(len(m.logodds_start.log_odds) for m in models_list)
    start_lo = np.zeros((g, n_start), dtype=np.float32)

    t_len = max_read_len // 3 + 3
    len_score = np.zeros((g, 3, t_len), dtype=np.float64)
    adj_tabs = []
    prior = np.zeros(g, dtype=np.float32)
    adj_or = np.zeros((g, 4), dtype=np.float32)
    isl = np.zeros(g, dtype=np.int32)

    pwm_lists = []
    user_pwms = []
    for gi, m in enumerate(models_list):
        prior[gi] = m.logodds_prior
        lo_s = m.logodds_start.log_odds
        start_lo[gi, : len(lo_s)] = lo_s
        ld = m.logodds_length
        # classes-mode LengthDist is a pure function of (length, trunc
        # flags) per cache entry: pre-evaluate it densely (length 0 is
        # unreachable; copy length 1 there)
        for L in range(1, t_len):
            len_score[gi, 0, L] = ld.score(L, False, False, max_read_len // 3)
            len_score[gi, 1, L] = ld.score(L, True, False, max_read_len // 3)
            len_score[gi, 2, L] = ld.score(L, True, True, max_read_len // 3)
        len_score[gi, :, 0] = len_score[gi, :, 1]
        ad = m.logodds_adj_dist
        adj_or[gi] = [m.logodds_adj_or.ff, m.logodds_adj_or.fr,
                      m.logodds_adj_or.rf, m.logodds_adj_or.rr]
        adj_tabs.append((ad.ff, ad.fr, ad.rf, ad.max_overlap))
        isl[gi] = min(int(m.ignore_score_len), int(BIG))
        meta = getattr(m, "_meta_pwms", None)
        if meta:
            pwm_lists.append([p.cols for p in meta])
            user_pwms.append(None)
        elif m.user_rbs and not m.logodds_pwm.is_empty():
            pwm_lists.append(None)
            user_pwms.append(m.logodds_pwm.cols)
        else:
            pwm_lists.append([])
            user_pwms.append(None)

    for ff, fr, rf, mo in adj_tabs:
        if mo not in (0, m0.max_olap_bases):
            raise ValueError("adj-dist max_overlap mismatch")

    d_max = max(max(len(t[0]), len(t[1]), len(t[2])) for t in adj_tabs)
    adj_dist = np.zeros((g, 3, d_max), dtype=np.float32)
    adj_dist_len = np.zeros((g, 3), dtype=np.int32)
    for gi, (ff, fr, rf, _mo) in enumerate(adj_tabs):
        for k, t in enumerate((ff, fr, rf)):
            adj_dist[gi, k, : len(t)] = t
            adj_dist[gi, k, len(t):] = t[-1]  # saturate pads at .back()
            adj_dist_len[gi, k] = len(t)

    widths = set()
    cmax = 1
    for gi in range(g):
        if pwm_lists[gi]:
            widths.update(p.shape[0] for p in pwm_lists[gi])
            cmax = max(cmax, len(pwm_lists[gi]))
        if user_pwms[gi] is not None:
            widths.add(user_pwms[gi].shape[0])
    if len(widths) > 1:
        raise ValueError("mixed PWM widths in one chunk")
    w = widths.pop() if widths else 0

    pwm_cols = np.zeros((g, cmax, max(w, 1), 4), dtype=np.float64)
    pwm_n = np.zeros(g, dtype=np.int32)
    pwm_user = np.zeros((g, max(w, 1), 4), dtype=np.float64)
    pwm_is_user = np.zeros(g, dtype=bool)
    gc_lp = np.zeros((g, 4), dtype=np.float64)
    for gi, m in enumerate(models_list):
        gc = m.indep_gc_frac
        gc_log = np.log(0.5 * np.float64(gc))
        at_log = np.log(0.5 * (1.0 - np.float64(gc)))
        gc_lp[gi] = [at_log, gc_log, gc_log, at_log]
        if pwm_lists[gi]:
            for ci, cols in enumerate(pwm_lists[gi]):
                pwm_cols[gi, ci] = cols
            pwm_n[gi] = len(pwm_lists[gi])
        elif user_pwms[gi] is not None:
            pwm_user[gi] = user_pwms[gi]
            pwm_is_user[gi] = True

    return DeviceBank(
        gene_mip=gmip, gene_probs=gprobs, indep_mip=imip, indep_probs=iprobs,
        model_len=m0.gene_icm.model_len, depth=max(
            m.gene_icm.model_depth for m in models_list),
        periodicity=m0.gene_icm.periodicity,
        fwd_start=np.stack([c["fwd_start"] for c in ct]),
        rev_start=np.stack([c["rev_start"] for c in ct]),
        fwd_stop=np.stack([c["fwd_stop"] for c in ct]),
        rev_stop=np.stack([c["rev_stop"] for c in ct]),
        which_fwd=np.stack([c["which_fwd"] for c in ct]),
        which_rev=np.stack([c["which_rev"] for c in ct]),
        prior=prior, start_lo=start_lo, len_score=len_score,
        adj_or=adj_or, adj_dist=adj_dist, adj_dist_len=adj_dist_len,
        ignore_score_len=isl,
        pwm_cols=pwm_cols, pwm_n=pwm_n, pwm_user=pwm_user,
        pwm_is_user=pwm_is_user, gc_lp=gc_lp,
        min_gene_len=m0.min_gene_len, max_olap=m0.max_olap_bases,
        event_threshold=m0.event_threshold,
        start_threshold=m0.start_threshold,
        ribosome_window=m0.ribosome_window_size,
        pwm_w=w,
    )


_BANK_FIELDS = (
    "gene_mip gene_probs indep_mip indep_probs "
    "fwd_start rev_start fwd_stop rev_stop which_fwd which_rev prior "
    "start_lo len_score adj_or adj_dist adj_dist_len ignore_score_len "
    "pwm_cols pwm_n pwm_user pwm_is_user gc_lp"
).split()


def bank_to_device(bank: DeviceBank, device) -> dict:
    """The bank's numpy tables as tensors on ``device`` (the counterpart
    of the JAX package's ``_bank_jnp``). Values are carried unchanged;
    the int8 ``which_*`` tables widen to int32."""
    device = torch.device(device)
    out = {}
    for f in _BANK_FIELDS:
        a = np.ascontiguousarray(getattr(bank, f))
        if a.dtype == np.int8:
            a = a.astype(np.int32)
        out[f] = torch.from_numpy(a).to(device)
    return out


# ---------------------------------------------------------------------------
# Frame-class scans, shifts and gathers over the last axis. A position's
# class is i % 3, so a (..., L) array is viewed as (..., L/3, 3) and the
# scan runs along dim -2.
# ---------------------------------------------------------------------------


def _cls3(vals):
    return vals.reshape(*vals.shape[:-1], -1, 3)


def _cls3_cummax(vals):
    """Running max within each i%3 class along the last axis."""
    return torch.cummax(_cls3(vals), dim=-2).values.reshape(vals.shape)


def _cls3_revcummin(vals):
    """Reverse running min within each i%3 class along the last axis."""
    v = torch.flip(_cls3(vals), dims=(-2,))
    return torch.flip(torch.cummin(v, dim=-2).values,
                      dims=(-2,)).reshape(vals.shape)


def _cls3_cumsum(vals):
    """Inclusive cumsum within each i%3 class along the last axis."""
    return torch.cumsum(_cls3(vals), dim=-2).to(vals.dtype).reshape(
        vals.shape)


def _fill_from(vals, idx, ok):
    v = _cls3(vals)
    out = torch.gather(v, -2, idx.clamp(0, v.shape[-2] - 1).long())
    return out.reshape(vals.shape), ok.reshape(vals.shape)


def _cls3_revfill(vals, valid):
    """out[q] = vals at the nearest valid position >= q in q's class
    (inclusive), with an any-valid flag; out is meaningful only where the
    flag is set."""
    f = _cls3(valid)
    k = f.shape[-2]
    ar = torch.arange(k, device=vals.device).view(k, 1)
    idx = torch.where(f, ar, k)
    idx = torch.flip(torch.cummin(torch.flip(idx, dims=(-2,)), dim=-2).values,
                     dims=(-2,))
    return _fill_from(vals, idx, idx < k)


def _cls3_fwdfill(vals, valid):
    """out[q] = vals at the nearest valid position <= q (same class)."""
    f = _cls3(valid)
    k = f.shape[-2]
    ar = torch.arange(k, device=vals.device).view(k, 1)
    idx = torch.cummax(torch.where(f, ar, -1), dim=-2).values
    return _fill_from(vals, idx, idx >= 0)


def _full(arr, shape, fill):
    return torch.full(shape, fill, dtype=arr.dtype, device=arr.device)


def _shift_right(arr, k, fill):
    """arr shifted right by k along the last axis (arr[..., i-k])."""
    if k == 0:
        return arr
    pad = _full(arr, arr.shape[:-1] + (k,), fill)
    return torch.cat([pad, arr[..., :-k]], dim=-1)


def _shift_left(arr, k, fill):
    """arr shifted left by k along the last axis (arr[..., i+k])."""
    if k == 0:
        return arr
    pad = _full(arr, arr.shape[:-1] + (k,), fill)
    return torch.cat([arr[..., k:], pad], dim=-1)


def _gather_guard(arr, idx, fill):
    """arr[b, idx[b, k]] along the last axis; out-of-range idx -> fill."""
    L = arr.shape[-1]
    idx = idx.expand(arr.shape[0], idx.shape[-1])
    ok = (idx >= 0) & (idx < L)
    got = torch.gather(arr, 1, idx.clamp(0, L - 1).long())
    return torch.where(ok, got, _full(arr, (), fill))


def _gather2(arr2, row, idx, fill):
    """arr2[b, row, idx] elementwise for arr2 (B, R, L); row/idx (B, K);
    out-of-range idx -> fill."""
    B, R, L = arr2.shape
    row, idx = torch.broadcast_tensors(row, idx)
    row = row.expand(B, row.shape[-1])
    idx = idx.expand(B, idx.shape[-1])
    ok = (idx >= 0) & (idx < L)
    flat = arr2.reshape(B, R * L)
    got = torch.gather(flat, 1, (row * L + idx.clamp(0, L - 1)).long())
    return torch.where(ok, got, _full(arr2, (), fill))


def _sel3(cols, ti):
    """cols: (B, 3); ti: (B, K) in {0,1,2} -> (B, K)."""
    return torch.where(
        ti == 0, cols[:, 0:1], torch.where(ti == 1, cols[:, 1:2], cols[:, 2:3])
    )


def _sel6(cols, ti):
    """cols: (B, 6); ti: (B, K) in {0..5} -> (B, K)."""
    out = cols[:, 0:1].expand(ti.shape)
    for k in range(1, 6):
        out = torch.where(ti == k, cols[:, k:k + 1], out)
    return out


# ---------------------------------------------------------------------------
# Batch entry point and host finish
# ---------------------------------------------------------------------------


def predict_batch_device(bank: DeviceBank, dev_bank: dict, reads, lengths,
                         groups, gene6, ind6, *, f64: bool = True,
                         subs: bool = False, quals=None):
    """Predict genes for a padded read batch on the batch's device.

    reads (B, L) int32, lengths (B,), groups (B,) bank indices, gene6/ind6
    (B, 6, L) f32 six-frame outputs, all tensors on one device; dev_bank is
    ``bank_to_device(bank, device)`` for that device. ``f64=False``
    carries event scores in f32 instead of f64. ``subs`` turns on the
    substitution mode (stop codons passed through at a penalty); ``quals``
    (B, L) uint8 per-base qualities, 255 in rows without a quality file,
    switches its penalty to the per-position quality form and is read
    only in that mode. Returns host numpy arrays (g_id, g_stop, g_len,
    g_sign, g_trunc, g_score, g_epos, g_etyp, cnt, n_flag); g_epos/g_etyp
    is a gene's substitution record (-1 for none), n_flag the event count,
    or MAX_EVENTS + 1 for reads the DP's row window could not serve.
    Spans ``predict.kf``, ``predict.k3`` and ``predict.fetch`` (the
    blocking download).
    """
    from . import event_dp_cuda, frontend_cuda

    b, L0 = reads.shape
    Lp = L0 + (-L0) % 3
    pad = Lp - L0
    consts = dict(
        min_gene_len=bank.min_gene_len, max_olap=bank.max_olap,
        event_threshold=bank.event_threshold,
        start_threshold=bank.start_threshold,
        ws=bank.ribosome_window, W=bank.pwm_w,
        fdt=torch.float64 if f64 else torch.float32,
        subs=bool(subs),
    )
    reads = torch.nn.functional.pad(reads.to(torch.int32), (0, pad))
    gene6 = torch.nn.functional.pad(gene6, (0, pad))
    ind6 = torch.nn.functional.pad(ind6, (0, pad))
    lengths = lengths.to(torch.int32)
    groups = groups.to(torch.int32)
    q = None
    if subs and quals is not None:
        q = torch.nn.functional.pad(quals.to(torch.uint8), (0, pad),
                                    value=255)

    max_events = MAX_EVENTS
    with observe.span("predict.kf"):
        ev, n_events = frontend_cuda.frontend(reads, lengths, groups, gene6,
                                              ind6, dev_bank, Lp, consts,
                                              max_events, quals=q)
    ne = torch.clamp(n_events, max=max_events)
    with observe.span("predict.k3"):
        _score, _bp, _best, wovf, *genes = event_dp_cuda.event_dp_traceback(
            ev, dev_bank, groups, consts, ne)
    n_flag = torch.where(wovf, max_events + 1, n_events).to(torch.int32)
    with observe.span("predict.fetch"):
        return [x.cpu().numpy() for x in (*genes, n_flag)]


def finish_genes(outs, n_reads: int):
    """Host-side tail of Trace_Back: reverse traceback order and fix up
    final 1-based coordinates (glimmer3.cc:1692-1759). Returns
    (list[list[TracedGene]], overflow mask)."""
    from ..engine.events import TracedGene
    from ..engine.mg_host import Error

    (g_id, g_stop, g_len, g_sign, g_trunc, g_score, g_epos, g_etyp,
     cnt, n_events) = outs
    overflow = (n_events > MAX_EVENTS) | (cnt > MAX_GENES)
    results = []
    for r in range(n_reads):
        genes = []
        for k in range(int(cnt[r])):
            sp = int(g_stop[r, k])
            fabs = 1 + ((sp + 2) % 3) if sp >= 0 else 3 - ((-sp) % 3)
            sign = int(g_sign[r, k])
            frame = fabs if sign > 0 else -fabs
            trunc = bool(g_trunc[r, k])
            if frame > 0:
                stop = sp + 2
                start = stop - int(g_len[r, k]) - 2
                if trunc:
                    start -= 3
            else:
                stop = sp
                start = stop + int(g_len[r, k]) + 2
                if trunc:
                    start += 3
            errors = ()
            if int(g_etyp[r, k]) >= 0:
                errors = (Error(int(g_epos[r, k]), int(g_etyp[r, k])),)
            genes.append(TracedGene(
                id=int(g_id[r, k]), start=start, stop=stop, frame=frame,
                score=float(g_score[r, k]), errors=errors, truncated=trunc,
            ))
        results.append(genes[::-1])
    return results, overflow
