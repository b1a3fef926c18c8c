"""Windowed event-graph DP and traceback over a batch of reads.

PyTorch counterpart of ``glimmer_mg_tpu.ops.device_predict``'s
``_event_dp_batched`` and ``_traceback_batched`` (Process_Events and
helpers, glimmer_base.cc:1530-1896; Trace_Back, glimmer3.cc:1631-1759).
Events of each read are position-sorted (B, E) rows; frame chains are
implicit, ``best`` holds the best event index per frame, and the
bounded-overlap re-link runs as masked updates on the WINDOW_ROWS events
before the current one. Candidate comparisons are f32, as the reference's
``float this_score, max_score``.

Where the JAX version wrote one-hot masked reductions (the fast form on a
TPU), this module uses ``torch.gather``: the same table reads. The state
tensors (score, bp, disq) are updated in place.

Host synchronisations per batch: one to read the loop bound max(ne), and
one per iteration of each disqualify/requalify chain walk (two walks per
DP step, each usually 0-2 iterations).
"""

from __future__ import annotations

import torch

from .device_predict import (
    BIG, E_FWD_START, E_FWD_STOP, E_REV_START, E_REV_STOP, F32, MAX_GENES,
    _sel3, _sel6,
)

I32 = torch.int32

# Re-link/adjacency row window: per DP step, arbitrary-index work is
# restricted to the last WINDOW_ROWS events before e. Both the re-link
# window (3 + pos[e] - pos <= max_olap) and the in-table adjacency range
# (pos[e] - pos <= max_olap + 6) only reach events within ~max_olap bases
# behind e, and events are position-sorted. Reads with an in-range event
# OUTSIDE the row window are flagged (wovf) and served by the host engine.
WINDOW_ROWS = 48

# Host synchronisations made by the last event_dp_batched call.
last_syncs = 0


def _oh_at(a, idx):
    """Batched ``a[b, clip(idx[b], 0, E-1)]`` for a (B, E), idx (B,)."""
    E = a.shape[-1]
    return torch.gather(a, 1, idx.clamp(0, E - 1).long()[:, None])[:, 0]


def _prefetch_adj(bank, groups):
    """Per-read adjacency tables, gathered by group once per batch.

    Returns ao (B, 4) f32, dl (B, 3) i32, tab (B, 3, D) f32 and satv (B, 3)
    f32 = tab[t, dl[t]-1] (the reference's ``.back()`` saturation value,
    gene.cc:798-925)."""
    gil = groups.long()
    ao = bank["adj_or"][gil]
    ad = bank["adj_dist"][gil]
    dl = bank["adj_dist_len"][gil]
    D = ad.shape[2]
    satv = torch.gather(ad, 2, (dl - 1).clamp(0, D - 1).long()[:, :, None])
    return dict(ao=ao, dl=dl, tab=ad, satv=satv[:, :, 0].to(F32), D=D)


def _adj_ti(t1, succ_fs):
    """AdjDist table index for pred type t1 -> successor (gene.cc:798-925);
    REV_START->REV_STOP reuses ff."""
    return torch.where(t1 == E_FWD_STOP, torch.where(succ_fs, 0, 1),
                       torch.where(succ_fs, 2, 0))


def _adj_or_b(adj, t1, succ_fs):
    """AdjOr piece: selects over the per-read (B, 4) log-odds."""
    ao = adj["ao"]
    zero = torch.zeros((), dtype=F32, device=ao.device)
    return torch.where(
        t1 == E_FWD_STOP,
        torch.where(succ_fs, ao[:, 0:1], ao[:, 1:2]),
        torch.where(t1 == E_REV_START,
                    torch.where(succ_fs, ao[:, 2:3], ao[:, 3:4]), zero),
    )


def _adj_dist_exact(adj, max_olap, ti, dist):
    """Exact AdjDist lookup on a (B, W) tile. Out-of-table indices
    saturate to tab[dl-1], the reference's unsigned-wrap ``.back()``."""
    D = adj["D"]
    dl = _sel3(adj["dl"], ti)
    idx = dist + max_olap
    ok = (idx >= 0) & (idx < dl)
    idx_eff = torch.where(ok, idx.clamp(0, D - 1), (dl - 1).clamp(0, D - 1))
    B = ti.shape[0]
    flat = adj["tab"].reshape(B, 3 * D)
    return torch.gather(flat, 1, (ti * D + idx_eff).long()).to(F32)


def _walk_set(disq, bp, pos, q, cutoff, value):
    """Disqualify/Requalify chain walk (glimmer_base.cc:437-458,
    2463-2480), all reads advanced together with per-read active masks.
    Bounded at E iterations: the best_pred graph is acyclic, so a correct
    walk visits < E nodes."""
    global last_syncs
    E = pos.shape[1]
    for _ in range(E):
        pos_q = torch.where(q >= 0, _oh_at(pos, q), -BIG)
        act = (q >= 0) & (pos_q >= cutoff)
        last_syncs += 1
        if not bool(act.any()):
            break
        qc = q.clamp(0, E - 1).long()[:, None]
        cur = torch.gather(disq, 1, qc)
        disq.scatter_(1, qc, torch.where(act[:, None], value, cur))
        q = torch.where(act, _oh_at(bp, q), q)


def _opener_best(e, score, best, processed, typ, pos, sub, je2, adj,
                 max_olap, wlo, W):
    """Best-predecessor scan for FWD_START/REV_STOP events: returns (max f32
    candidate, winner index) per read."""
    B, E = typ.shape
    te_c = typ[:, e][:, None]
    pos_e = pos[:, e][:, None]
    succ_fs = te_c == E_FWD_START
    # adjacency to e: saturated value everywhere, exact on the window
    di_s = _sel3(adj["satv"], _adj_ti(typ, succ_fs))
    or_s = _adj_or_b(adj, typ, succ_fs)
    typ_w = typ[:, wlo:wlo + W]
    di_s[:, wlo:wlo + W] = _adj_dist_exact(
        adj, max_olap, _adj_ti(typ_w, succ_fs),
        pos_e - pos[:, wlo:wlo + W] - 3)
    cand_f32 = (score + or_s.to(score.dtype) + di_s.to(score.dtype)).to(F32)

    between = (processed & ((typ == E_FWD_STOP) | (typ == E_REV_START))
               & (score > 0.0) & (je2 > _sel6(best, sub)))
    rank_btw = (sub + 1) * (2 * E) + (E - je2)

    extra = torch.zeros((B, E), dtype=torch.bool, device=typ.device)
    ei_cols = []
    neg_inf = torch.tensor(float("-inf"), dtype=F32, device=typ.device)
    zero32 = torch.zeros((), dtype=F32, device=typ.device)
    for i in range(6):
        bei = best[:, i]
        has = bei >= 0
        btyp = torch.where(has, _oh_at(typ, bei), -1)
        k_mask = processed & (sub == i) & (je2 <= bei[:, None])
        m_i = torch.amax(
            torch.where(k_mask & (typ != E_REV_START), je2, -1), dim=1)
        fr_extra = torch.where(
            (btyp == E_FWD_STOP)[:, None], je2 == bei[:, None],
            (btyp == E_REV_START)[:, None] & k_mask & (je2 > m_i[:, None]))
        extra = extra | fr_extra
        ei_cols.append(torch.where(has, neg_inf, zero32))
    extra_init_score = torch.stack(ei_cols, dim=1)  # (B, 6)
    rank_ext = (sub + 1) * (2 * E) + E + (E - je2)

    cand_mask = between | extra
    rank = torch.where(between, rank_btw, rank_ext)

    b0 = best[:, 0]
    init_score = torch.where(b0 >= 0, _oh_at(cand_f32, b0), zero32)

    scores_all = torch.cat(
        [torch.where(cand_mask, cand_f32, neg_inf), init_score[:, None],
         extra_init_score], dim=1)
    j6 = torch.arange(6, dtype=I32, device=typ.device)[None, :]
    ranks_all = torch.cat(
        [rank.to(I32), torch.zeros((B, 1), dtype=I32, device=typ.device),
         ((j6 + 1) * (2 * E) + E).expand(B, 6)], dim=1)
    idx_all = torch.cat(
        [je2.expand(B, E), b0[:, None],
         torch.full((B, 6), -1, dtype=I32, device=typ.device)], dim=1)
    m = torch.amax(scores_all, dim=1)
    at_m = scores_all == m[:, None]
    winner_rank = torch.amin(torch.where(at_m, ranks_all, BIG), dim=1)
    wsel = at_m & (ranks_all == winner_rank[:, None])
    w = torch.argmax(wsel.to(torch.uint8), dim=1)
    return m, torch.gather(idx_all, 1, w[:, None])[:, 0].to(I32)


def event_dp_batched(ev, adj, consts, ne):
    """Process_Events over (B, E) event rows; ne (B,) real event counts.

    The loop runs to max(ne); reads whose events are exhausted see typ == 0
    padding rows (inactive). Returns (score, bp, best, wovf) where wovf
    flags reads the row window could not serve (host fallback).
    """
    global last_syncs
    last_syncs = 0
    B, E = ev["pos"].shape
    W = min(WINDOW_ROWS, E)
    pos, typ, sub, eid = ev["pos"], ev["typ"], ev["sub"], ev["id"]
    dev = pos.device
    max_olap = consts["max_olap"]
    je2 = torch.arange(E, dtype=I32, device=dev)[None, :]
    jwr = torch.arange(W, dtype=I32, device=dev)

    score = ev["score"].clone()
    zS = torch.zeros((), dtype=score.dtype, device=dev)
    bp = torch.full((B, E), -2, dtype=I32, device=dev)
    disq = torch.zeros((B, E), dtype=torch.bool, device=dev)
    best = torch.full((B, 6), -1, dtype=I32, device=dev)
    wovf = torch.zeros((B,), dtype=torch.bool, device=dev)
    j6 = torch.arange(6, device=dev)[None, :]

    hi = int(torch.clamp(ne, max=E).max()) if B else 0
    last_syncs += 1
    for e in range(hi):
        te = typ[:, e]
        pos_e = pos[:, e]
        sub_e = sub[:, e]
        score_e = score[:, e].clone()
        active = te != 0
        is_open = (te == E_FWD_START) | (te == E_REV_STOP)
        is_fs = te == E_FWD_STOP
        is_rs = te == E_REV_START
        processed = je2 < e

        wlo = max(e - W, 0)
        assert wlo + W <= E
        typ_w = typ[:, wlo:wlo + W]
        pos_w = pos[:, wlo:wlo + W]
        sub_w = sub[:, wlo:wlo + W]
        proc_w = (wlo + jwr[None, :]) < e

        # row-window sufficiency: a processed event OUTSIDE the window rows
        # but within adjacency/base range flags the read for the host
        out_rng = (processed & (je2 < wlo)
                   & (pos_e[:, None] - pos <= max_olap + 6))
        wovf = wovf | (active & out_rng.any(dim=1))

        m_open, w_open = _opener_best(e, score, best, processed, typ, pos,
                                      sub, je2, adj, max_olap, wlo, W)

        cand_id = (processed & (sub == sub_e[:, None])
                   & (eid == eid[:, e:e + 1]))
        neg = torch.tensor(float("-inf"), dtype=score.dtype, device=dev)
        m_fs = torch.amax(torch.where(cand_id, score, neg), dim=1)
        w_fs = torch.amax(torch.where(cand_id & (score == m_fs[:, None]), je2,
                                      -1), dim=1).to(I32)
        p_rs = torch.amax(torch.where(cand_id & (typ != E_REV_START), je2, -1),
                          dim=1).to(I32)

        new_e_score = torch.where(
            is_open, score_e + m_open.to(score.dtype),
            torch.where(is_fs, m_fs,
                        torch.where(is_rs, score_e + _oh_at(score, p_rs),
                                    score_e)))
        new_e_bp = torch.where(
            is_open, w_open,
            torch.where(is_fs, w_fs, torch.where(is_rs, p_rs, bp[:, e])))
        score[:, e] = torch.where(active, new_e_score, score_e)
        bp[:, e] = torch.where(active, new_e_bp, bp[:, e])
        score_e = score[:, e].clone()

        # ---- closure (Process_Fwd_Stop_Rev_Start tail), masked by `do` ----
        be = torch.gather(best, 1, sub_e.long()[:, None])[:, 0]
        be_s = torch.where(be >= 0, _oh_at(score, be), zS)
        do = (is_fs | is_rs) & (be_s < score_e)
        p_disq = torch.where(is_rs, p_rs, -1)
        cutoff = 3 + pos_e - max_olap
        q0 = torch.where(do & (p_disq >= 0), _oh_at(bp, p_disq), -1)
        _walk_set(disq, bp, pos, q0, cutoff, True)
        best = torch.where((j6 == sub_e[:, None]) & do[:, None], e,
                           best).to(I32)

        # ---- bounded-overlap re-link, on the row window only ----
        bp_w = bp[:, wlo:wlo + W]
        valid_bpw = bp_w >= 0
        bpc = bp_w.clamp(0, E - 1).long()
        needed_w = torch.where(valid_bpw, torch.gather(score, 1, bpc), zS)
        bptyp_w = torch.where(valid_bpw, torch.gather(typ, 1, bpc), 0)
        bppos_w = torch.gather(pos, 1, bpc)
        window_w = proc_w & (3 + pos_e[:, None] - pos_w <= max_olap)
        opener_w = (typ_w == E_FWD_START) | (typ_w == E_REV_STOP)
        cand_w = (do[:, None] & window_w & ~disq[:, wlo:wlo + W] & opener_w
                  & (needed_w < score_e[:, None]))

        succ_fs_w = typ_w == E_FWD_START
        oo_w = _adj_or_b(adj, bptyp_w, succ_fs_w)
        od_w = _adj_dist_exact(adj, max_olap, _adj_ti(bptyp_w, succ_fs_w),
                               pos_w - bppos_w - 3)
        old_adj_w = torch.where(valid_bpw, oo_w + od_w,
                                torch.zeros((), dtype=F32, device=dev))
        te_c = te[:, None]
        new_adj_w = (_adj_or_b(adj, te_c, succ_fs_w)
                     + _adj_dist_exact(adj, max_olap, _adj_ti(te_c, succ_fs_w),
                                       pos_w - pos_e[:, None] - 3))
        diff_w = ((score_e[:, None] - needed_w)
                  + (new_adj_w - old_adj_w).to(score.dtype))
        upd_w = cand_w & (diff_w > 0.0)

        # successor propagation over the full rows: a successor's pred is
        # in the window iff its bp lands in [wlo, wlo+W)
        rel = bp - wlo
        inw = (bp >= 0) & (rel >= 0) & (rel < W)
        relc = rel.clamp(0, W - 1).long()
        upd_at = inw & torch.gather(upd_w, 1, relc)
        sub_at = torch.where(inw, torch.gather(sub_w, 1, relc), 0)
        diff_at = torch.where(inw, torch.gather(diff_w, 1, relc), zS)
        prop = processed & upd_at & (sub == sub_at) & (je2 > bp)
        score += torch.where(prop, diff_at, zS)
        score[:, wlo:wlo + W] += torch.where(upd_w, diff_w, zS)
        bp[:, wlo:wlo + W] = torch.where(upd_w, e, bp_w).to(I32)

        q0b = torch.where(do & (p_disq >= 0), _oh_at(bp, p_disq), -1)
        _walk_set(disq, bp, pos, q0b, cutoff, False)
    return score, bp, best, wovf


def traceback_batched(ev, score, bp, best, ne):
    """Set_Final_Event + Trace_Back over (B, E): raw gene records (id,
    stop, len, sign, trunc, score) in traceback order, per read."""
    B, E = ev["pos"].shape
    pos, typ, eid, trunc = ev["pos"], ev["typ"], ev["id"], ev["trunc"]
    dev = pos.device
    zS = torch.zeros((), dtype=score.dtype, device=dev)

    s6 = torch.stack([torch.where(best[:, i] >= 0, _oh_at(score, best[:, i]),
                                  zS) for i in range(6)], dim=1)
    fe = best[:, 0]
    fs = s6[:, 0]
    for i in range(1, 6):
        take = s6[:, i] >= fs
        fe = torch.where(take, best[:, i], fe)
        fs = torch.where(take, s6[:, i], fs)

    p = fe.clone()
    zi = torch.zeros((B,), dtype=I32, device=dev)
    cur_stop, rev_start_pos = zi.clone(), zi.clone()
    prev_score = torch.zeros((B,), dtype=score.dtype, device=dev)
    rev_trunc = torch.zeros((B,), dtype=torch.bool, device=dev)
    zg = torch.zeros((B, MAX_GENES), dtype=I32, device=dev)
    g_id, g_stop, g_len, g_sign = (zg.clone() for _ in range(4))
    g_trunc = torch.zeros((B, MAX_GENES), dtype=torch.bool, device=dev)
    g_score = torch.zeros((B, MAX_GENES), dtype=score.dtype, device=dev)
    cnt = zi.clone()
    rows = torch.arange(B, device=dev)

    hi = int(torch.clamp(ne, max=E).max()) if B else 0
    for _k in range(hi):
        active = p >= 0
        typ_p = _oh_at(typ, p)
        bpp = _oh_at(bp, p)
        score_p = _oh_at(score, p)
        pos_p = _oh_at(pos, p)
        trunc_p = _oh_at(trunc, p)
        tp = torch.where(active, typ_p, 0)

        emit_f = tp == E_FWD_START
        emit_r = tp == E_REV_STOP
        emit = emit_f | emit_r
        score_bpp = torch.where(bpp >= 0, _oh_at(score, bpp), zS)
        rec_stop = torch.where(emit_f, cur_stop, pos_p - 2)
        rec_len = torch.where(emit_f, 2 + cur_stop - pos_p,
                              rev_start_pos - pos_p)
        rec_sign = torch.where(emit_f, 1, -1).to(I32)
        rec_trunc = torch.where(emit_f, trunc_p, rev_trunc)
        rec_score = torch.where(emit_f, score_p - score_bpp,
                                prev_score - score_p)

        slot = cnt.clamp(0, MAX_GENES - 1).long()
        for g, rec in ((g_id, _oh_at(eid, p)), (g_stop, rec_stop),
                       (g_len, rec_len), (g_sign, rec_sign),
                       (g_trunc, rec_trunc), (g_score, rec_score)):
            g[rows, slot] = torch.where(emit, rec.to(g.dtype), g[rows, slot])
        cnt = cnt + emit.to(I32)

        is_rs = tp == E_REV_START
        cur_stop = torch.where((tp == E_FWD_STOP) | emit_r, pos_p - 2,
                               cur_stop)
        rev_start_pos = torch.where(is_rs, pos_p, rev_start_pos)
        prev_score = torch.where(is_rs, score_p, prev_score)
        rev_trunc = torch.where(is_rs, trunc_p, rev_trunc)
        p = torch.where(active, bpp, p)
    return g_id, g_stop, g_len, g_sign, g_trunc, g_score, cnt
