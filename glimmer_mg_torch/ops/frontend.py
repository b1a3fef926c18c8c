"""ORF/start-candidate frontend and event assembly, batched over reads.

PyTorch counterpart of the frontend of
``glimmer_mg_tpu.ops.device_predict`` (``_read_tables`` through
``_frontend_one``). Everything is written over (B, Lp) tensors, Lp a
multiple of 3; per-ORF values live at the ORF's closing-stop position and
reach the ORF's members through frame-class fill scans.

This is the plain version of KF (``csrc/frontend.cu``, launched by
``ops.frontend_cuda.frontend`` on CUDA tensors) in both modes, error-free
and substitution (``consts["subs"]``, with or without qualities), which
matches it bit for bit; float operations keep one order on every device
for that (the class-PWM sum, true divisions, the stop penalty's products).

Reference anchors (behavioural spec):
  Find_Orfs / Do_*_Stop_Codon        glimmer_base.cc:461-780
  Score_Orfs_Errors / Score_Orf_Starts  glimmer-mg.cc:1605-1860
  Add_Events_Fwd / Add_Events_Rev    glimmer_base.cc:43-263
  Add_PWM_Score                      glimmer_base.cc:267-295
  PWM_Meta_Score_Fwd/Rev_Start       glimmer-mg.cc:1900-2060
  Pass_Stop_Penalty                  glimmer-mg.cc:961

In substitution mode (``consts["subs"]``) each strand gains two candidate
families: starts whose gene runs through a stop codon, taken as a
sequencing error at a penalty, into the next ORF of the same frame. Such
a candidate's error record rides its event (``err_pos``/``err_typ``), and
each (ORF, error set) gets its own id and stop event.
"""

from __future__ import annotations

import math

import torch

from .device_predict import (
    BIG, E_FWD_START, E_FWD_STOP, E_REV_START, E_REV_STOP, _CP_TAB,
    _cls3_cummax, _cls3_cumsum, _cls3_fwdfill, _cls3_revcummin,
    _cls3_revfill, _full, _gather2, _gather_guard, _sel3, _shift_left,
    _shift_right,
)

I32 = torch.int32
NEG_INF = float("-inf")
# engine.mg_host.MIN_INDEL_ORF_LEN: the error modes keep ORFs this long
MIN_INDEL_ORF_LEN = 15
# error type of a substitution record (engine.mg_host.Error)
ERR_SUB = 2


def _ar(n, device):
    return torch.arange(n, dtype=I32, device=device)


def _zero(x):
    return _full(x, (), 0)


def stop_penalty_values():
    """The four no-quality Pass_Stop_Penalty values as the host computes
    them (Python floats, ``math.log``), at index 2 * mid + last: the
    codon's middle / last base (in the gene's direction) is the one the
    reference weighs up. KF (``csrc/frontend.cu``) is given these."""
    dp = 0.999
    fa = 2.0 / 3.0 * dp + 1.0 / 3.0

    def pen(mid, last):
        pp = dp * (fa if mid else dp) * (fa if last else dp)
        return math.log(1.0 - pp) - math.log(pp)

    return tuple(pen(mid, last) for mid in (False, True)
                 for last in (False, True))


_CP_DEV: dict = {}


def cp_table(device):
    """``_CP_TAB`` (256,) f64 on ``device``, copied from the host once a
    device (a host copy synchronises the stream)."""
    device = torch.device(device)
    if device not in _CP_DEV:
        _CP_DEV[device] = torch.as_tensor(_CP_TAB, device=device)
    return _CP_DEV[device]


def _stop_penalty(mid_x, last_x, quals, fwd, fdt):
    """Pass_Stop_Penalty (glimmer-mg.cc:961) of a stop codon read through
    as a substitution, at every position x of its last base: (B, Lp) in
    ``fdt``. ``mid_x``/``last_x`` flag the codon's middle and last base
    (in the gene's direction) as the base the reference weighs up ('a'
    forward, 't' reverse); ``quals`` (B, Lp) uint8 or None.

    Without qualities the four possible values are Python floats, rounded
    to ``fdt`` once, as the host computes them. With qualities the
    per-base probabilities come from ``_CP_TAB`` and multiply in the
    host's order; pp is clipped into (0, 1) so the extremes stay finite.
    The constants are filled on the device (``torch.full``), not copied
    from the host, which would synchronise the stream.
    """
    dev = mid_x.device

    def const(v):
        return torch.full((), v, dtype=fdt, device=dev)

    if quals is None:
        ff, ft, tf, tt = (const(v) for v in stop_penalty_values())
        return torch.where(mid_x, torch.where(last_x, tt, tf),
                           torch.where(last_x, ft, ff))
    cp = cp_table(dev).to(fdt)[quals.long()]
    cp1 = _shift_right(cp, 1, 0.5)
    cp0 = _shift_right(cp, 2, 0.5)
    two3, one3 = const(2.0 / 3.0), const(1.0 / 3.0)

    def fa_of(is_x, c):
        return torch.where(is_x, two3 * c + one3, c)

    # the codon is seq[x-2..x]; forward its first base is x-2, reverse x
    if fwd:
        pp = (cp0 * fa_of(mid_x, cp1)) * fa_of(last_x, cp)
    else:
        pp = (cp * fa_of(mid_x, cp1)) * fa_of(last_x, cp0)
    fi = torch.finfo(fdt)
    pp = pp.clamp(min=fi.tiny, max=1.0 - fi.eps / 2)
    return torch.log(1.0 - pp) - torch.log(pp)


def _read_tables(seq, n, gi, bank):
    """Per-position codon-class tables and frame-class scans.

    seq: (B, Lp) i32, n/gi: (B,). Mirrors the host's boolean codon arrays
    (engine.orfs.scan_codons), the stop-index registers
    (MgSequenceState._save_prev_stops, glimmer-mg.cc:675) and the
    next/previous start/stop scans the ORF assembler queries.
    """
    B, Lp = seq.shape
    i = _ar(Lp, seq.device)[None, :]
    n2 = n[:, None]
    valid = i < n2

    s0 = _shift_right(seq, 2, 0)
    s1 = _shift_right(seq, 1, 0)
    cod6 = torch.where((i >= 2) & valid, s0 * 16 + s1 * 4 + seq, 64).long()

    t = {}
    gil = gi.long()

    def ctab(key):
        return torch.gather(bank[key][gil], 1, cod6)

    t["is_fwd_start"] = ctab("fwd_start")
    t["is_rev_start"] = ctab("rev_start")
    t["is_fwd_stop"] = ctab("fwd_stop")
    t["is_rev_stop"] = ctab("rev_stop")
    t["which_fwd"] = ctab("which_fwd").to(I32)
    t["which_rev"] = ctab("which_rev").to(I32)

    def at(mask, fill):
        return torch.where(mask, i, fill).to(I32)

    t["pstop_f"] = _cls3_cummax(at(t["is_fwd_stop"], -BIG))
    t["nstop_f"] = _cls3_revcummin(at(t["is_fwd_stop"], BIG))
    t["pstop_r"] = _cls3_cummax(at(t["is_rev_stop"], -BIG))
    t["nstop_r"] = _cls3_revcummin(at(t["is_rev_stop"], BIG))
    t["nstart_f"] = _cls3_revcummin(at(t["is_fwd_start"], BIG))
    t["pstart_r"] = _cls3_cummax(at(t["is_rev_start"], -BIG))

    # Save_Prev_Stops registers: previous fwd stop / next rev stop
    cls = i % 3
    init_f = torch.where(cls == 0, 0, torch.where(cls == 1, 1, -1)).to(I32)
    t["fwd_prev"] = torch.maximum(init_f, t["pstop_f"])
    f_r = (n2 - 1 - i) % 3
    init_r = torch.where(f_r == 0, n2 - 1,
                         torch.where(f_r == 1, n2 - 2, n2)).to(I32)
    hit_r = _shift_left(t["is_rev_stop"], 2, False)
    rn_cand = _cls3_revcummin(at(hit_r, BIG))
    t["rev_next"] = torch.minimum(init_r, rn_cand)
    return t


def _cat(a, b, B, Lp):
    return torch.cat([a.expand(B, Lp), b.expand(B, 3)], dim=1)


def _fwd_orf_slots(t, n, Lp, min_gene_len, indel_orfs=False):
    """Forward-ORF candidate slots: Lp real (by stop last-base subscript)
    + 3 virtual truncated stops at subscripts n..n+2 (Do_Fwd_Stop_Codon /
    Handle_First_Forward_Stop, glimmer_base.cc:461-506, 946-974).
    ``indel_orfs`` (the error modes) also keeps ORFs too short for a gene
    whose frame length reaches MIN_INDEL_ORF_LEN (the host find_orfs
    keep_len rule)."""
    B = n.shape[0]
    dev = n.device
    n2 = n[:, None]
    k3 = _ar(3, dev)[None, :]
    stop_m = t["is_fwd_stop"]
    pos = _ar(Lp, dev)[None, :]

    iS_r = pos.expand(B, Lp)
    iS_v = n2 + k3
    cv = iS_v % 3

    ip_r = _shift_right(t["pstop_f"], 3, -BIG)
    ip_v = _sel3(t["pstop_f"][:, Lp - 3:], cv)  # last stop in the class
    has_prev_r = ip_r > -BIG // 2
    has_prev_v = ip_v > -BIG // 2

    # first fwd start after the previous stop: forward-fill of
    # nstart_f[p+3] placed at stop positions, read at s-3 / class end
    H = _shift_left(t["nstart_f"], 3, BIG)
    FFv, FFok = _cls3_fwdfill(torch.where(stop_m, H, BIG), stop_m)
    ssp = torch.where(FFok, FFv, BIG)
    ss_prev_r = _shift_right(ssp, 3, BIG)
    ss_prev_v = _sel3(ssp[:, Lp - 3:], cv)
    np_cols = torch.stack(
        [t["nstart_f"][:, 3], t["nstart_f"][:, 4], t["nstart_f"][:, 2]],
        dim=1)                                    # no-prev: nstart_f[c0]
    ss_np_r = _sel3(np_cols, (pos % 3).expand(B, Lp))
    ss_np_v = _sel3(np_cols, cv)
    s_star_r = torch.where(has_prev_r, ss_prev_r, ss_np_r)
    s_star_v = torch.where(has_prev_v, ss_prev_v, ss_np_v)

    def gene_emit(iS, ip, has_prev, s_star, slot_exists):
        gl = torch.where(s_star < iS, iS - s_star, 0)
        ol = torch.where(has_prev, iS - ip - 3, (iS - 2) - ((iS - 2) % 3))
        gl = torch.where((~has_prev) & (gl < min_gene_len), ol, gl)
        keep = gl >= min_gene_len
        if indel_orfs:
            keep = keep | (ol >= MIN_INDEL_ORF_LEN)
        return slot_exists & keep

    emit_r = gene_emit(iS_r, ip_r, has_prev_r, s_star_r, stop_m)
    emit_v = gene_emit(iS_v, ip_v, has_prev_v, s_star_v, True)

    # scorer bounds (Cumulative_Frame_Score segment): lo = fps(iS-3)+1
    lo_r = torch.where(
        pos >= 3, _shift_right(t["fwd_prev"], 3, 0), pos - 3
    ) + 1
    xv = n2 + k3 - 3
    fpv = _gather_guard(t["fwd_prev"], xv, 0)
    lo_v = torch.where((xv >= 0) & (xv < n2), fpv, xv) + 1

    iS = _cat(iS_r, iS_v, B, Lp)
    emit = _cat(emit_r, emit_v, B, Lp)
    lo = _cat(lo_r, lo_v, B, Lp)
    hi = iS - 2
    mm = hi - lo
    top_j = torch.clamp(torch.div(mm - 1, 3, rounding_mode="floor") * 3,
                        min=-3)
    orf_trunc = lo < 3
    t3 = _cat(pos.expand(B, Lp) >= n2,
              torch.ones((B, 3), dtype=torch.bool, device=dev), B, Lp)
    key = _cat(2 * iS_r + 1, 2 * Lp + 8 + k3, B, Lp)
    return {
        "iS": iS, "emit": emit, "lo": lo, "hi": hi, "mm": mm,
        "top_j": top_j, "orf_trunc": orf_trunc, "t3": t3, "key": key,
        "stop_pos": iS - 1,
    }


def _rev_orf_slots(t, n, Lp, min_gene_len, indel_orfs=False):
    """Reverse-ORF candidate slots: Lp real (closing rev-stop subscript)
    + 3 end-of-sequence slots (frame classes 0..2) (Do_Rev_Stop_Codon /
    Handle_First_Reverse_Stop / Finish_Orfs, glimmer_base.cc:509-539,
    978-1000, 783-806; allow_truncated linear). ``indel_orfs`` as in
    :func:`_fwd_orf_slots`."""
    B = n.shape[0]
    dev = n.device
    n2 = n[:, None]
    k3 = _ar(3, dev)[None, :]
    stop_m = t["is_rev_stop"]
    pos = _ar(Lp, dev)[None, :]

    c_r = (pos % 3).expand(B, Lp)

    ip_r = _shift_right(t["pstop_r"], 3, -BIG)
    ip_v = t["pstop_r"][:, Lp - 3:]              # class tops, column k
    has_prev_r = ip_r > -BIG // 2
    has_prev_v = ip_v > -BIG // 2

    def vstop_of(c):
        return torch.where(c == 0, -1, torch.where(c == 1, 0, -2)).to(I32)

    orf_stop_r = torch.where(has_prev_r, ip_r - 1, vstop_of(c_r))
    orf_stop_v = torch.where(has_prev_v, ip_v - 1, vstop_of(k3))

    # last rev start inside the segment
    ls_r = _shift_right(t["pstart_r"], 3, -BIG)       # pstart_r[iC-3]
    ls_v = _gather_guard(t["pstart_r"], (n2 - 3).expand(B, 3), -BIG)

    def gene_len(ls, ip, has_prev, orf_stop):
        ls_ok = (ls > torch.where(has_prev, ip, -BIG)) & (ls > -BIG // 2)
        return torch.where(ls_ok, (ls - 1) - orf_stop, 0)

    gl_r = gene_len(ls_r, ip_r, has_prev_r, orf_stop_r)
    keep_r = gl_r >= min_gene_len
    gl_v = gene_len(ls_v, ip_v, has_prev_v, orf_stop_v)
    end_orf_len = n2 - orf_stop_v - 2
    end_orf_len = end_orf_len - end_orf_len % 3
    gl_v = torch.where(gl_v < min_gene_len, end_orf_len, gl_v)
    keep_v = gl_v >= min_gene_len
    if indel_orfs:
        keep_r = keep_r | (pos - orf_stop_r - 4 >= MIN_INDEL_ORF_LEN)
        keep_v = keep_v | (end_orf_len >= MIN_INDEL_ORF_LEN)
    emit_r = stop_m & keep_r
    emit_v = keep_v

    # hi = rev_next[end_point - 1] + 1: the has-prev branch reads the
    # register at prev_stop+1 (forward-fill of rev_next[p+1] placed at
    # stops), the no-prev branch reads fixed columns {1,2,0} per class
    Hn = _shift_left(t["rev_next"], 1, 0)
    FFn, FFnok = _cls3_fwdfill(torch.where(stop_m, Hn, 0), stop_m)
    rn_cols = torch.stack(
        [t["rev_next"][:, 1], t["rev_next"][:, 2], t["rev_next"][:, 0]],
        dim=1)                                    # x = vstop+2 in {1,2,0}

    def hi_of(x_ep, ff_val, has_prev, c):
        rnv = torch.where(has_prev, ff_val, _sel3(rn_cols, c))
        inside = (x_ep >= 0) & (x_ep < n2)
        return torch.where(inside, rnv, x_ep) + 1

    ffn = torch.where(FFnok, FFn, 0)
    hi_r = hi_of(orf_stop_r + 2, _shift_right(ffn, 3, 0), has_prev_r, c_r)
    hi_v = hi_of(orf_stop_v + 2, ffn[:, Lp - 3:], has_prev_v, k3)

    idx = _ar(Lp + 3, dev)[None, :]
    real = idx < Lp
    iC = _cat(pos.expand(B, Lp), n2 + k3, B, Lp)
    orf_stop = _cat(orf_stop_r, orf_stop_v, B, Lp)
    emit = _cat(emit_r, emit_v, B, Lp)
    hi = _cat(hi_r, hi_v, B, Lp)
    lo = orf_stop + 3
    mm = hi - lo
    top_j = torch.clamp(torch.div(mm - 1, 3, rounding_mode="floor") * 3,
                        min=-3)
    orf_trunc = (n2 - (hi - 1)) < 3
    t3 = orf_stop < 1
    key = torch.where(real, 2 * iC, 2 * Lp + 4 + (idx - Lp))
    return {
        "emit": emit, "lo": lo, "hi": hi, "mm": mm, "top_j": top_j,
        "orf_trunc": orf_trunc, "t3": t3, "key": key, "stop_pos": orf_stop,
    }


# ---------------------------------------------------------------------------
# Start scoring: LLR prefix sums and RBS scorers
# ---------------------------------------------------------------------------


def _seq_cumsum(x):
    """Left-to-right inclusive cumsum along the last axis."""
    cols = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., k])
    return torch.stack(cols, dim=-1)


def _blocked_cumsum(x, block: int = 16):
    """Inclusive float cumsum along the last axis in a fixed order: a
    sequential scan inside blocks of 16, plus the (recursively blocked)
    scan of the block totals. This is the order XLA's CPU backend sums a
    ``jnp.cumsum`` in, so the port's prefix sums equal the JAX
    reference's bit for bit on any device; ``torch.cumsum`` orders its
    sums differently on the CPU and on the GPU."""
    n = x.shape[-1]
    nb = -(-n // block)
    xp = torch.nn.functional.pad(x, (0, nb * block - n))
    inner = _seq_cumsum(xp.reshape(*x.shape[:-1], nb, block))
    tot = inner[..., -1]
    ctot = _blocked_cumsum(tot, block) if nb > block else _seq_cumsum(tot)
    excl = torch.nn.functional.pad(ctot[..., :-1], (1, 0))
    return (inner + excl[..., None]).reshape(*x.shape[:-1], nb * block)[
        ..., :n]


def _frame_prefix_sums(gene6, ind6, n, Lp, fdt):
    """Per-frame LLR prefix sums in read coordinates.

    gene6/ind6 (B, 6, Lp) are the six-frame outputs (rows 0-2 over the
    reversed read, 3-5 over the complemented read). Returns (Sf, Sr), each
    (B, 3, Lp): Sf[c] are inclusive prefix sums of the per-base values
    every forward ORF in stop-class c reads (Cumulative_Frame_Score's
    cycling f = (1+t)%3, glimmer-mg.cc:561), Sr[c] the reverse analogue.
    """
    dev = gene6.device
    p = _ar(Lp, dev)
    valid = p[None, :] < n[:, None]
    # rows 0-2 are over the reversed read: x[n-1-p] back in read order
    ridx = (n[:, None] - 1 - p[None, :]).clamp(min=0).long()
    ridx = ridx[:, None, :].expand(-1, 3, -1)
    diff_f = gene6[:, :3].to(fdt) - ind6[:, :3].to(fdt)
    zero = torch.zeros((), dtype=fdt, device=dev)
    fs_f = torch.where(valid[:, None, :], torch.gather(diff_f, 2, ridx), zero)
    fs_r = torch.where(valid[:, None, :],
                       gene6[:, 3:].to(fdt) - ind6[:, 3:].to(fdt), zero)
    c = _ar(3, dev)[:, None]

    def rowsel(x, rows):
        r = rows[None, :, :]
        return torch.where(
            r == 0, x[:, 0:1, :],
            torch.where(r == 1, x[:, 1:2, :], x[:, 2:3, :]))

    Sf = _blocked_cumsum(rowsel(fs_f, (c + 1 - p[None, :]) % 3))
    Sr = _blocked_cumsum(rowsel(fs_r, (p[None, :] - c) % 3))
    return Sf, Sr


def _pwm_arrays(seq, gi, bank, pwm_w: int, fdt):
    """Whole-read RBS window scores (one entry per window start).

    Mixture mode mirrors MetaPwmScorer._precompute (PWM_Meta_Score_*,
    glimmer-mg.cc:1900-2060): log(mean over class PWMs of the window
    probability product) minus the GC-background log sum. User mode
    mirrors PwmScorer (log-odds column sums).
    """
    B, Lp = seq.shape
    dev = seq.device
    comp = 3 - seq
    gil = gi.long()
    cols = bank["pwm_cols"][gil].to(fdt)      # (B, C, W, 4)
    nm = bank["pwm_n"][gil]                   # (B,)
    ucols = bank["pwm_user"][gil].to(fdt)     # (B, W, 4)
    gclp = bank["gc_lp"][gil].to(fdt)         # (B, 4)
    C = cols.shape[1]

    def sel4_2d(tab, b):
        return torch.gather(tab, 1, b.long())

    def sel4_3d(tab, b):
        return torch.gather(tab, 2, b.long()[:, None, :].expand(B, C, Lp))

    prod_f = torch.ones((B, C, Lp), dtype=fdt, device=dev)
    prod_r = torch.ones((B, C, Lp), dtype=fdt, device=dev)
    gcf = torch.zeros((B, Lp), dtype=fdt, device=dev)
    gcr = torch.zeros((B, Lp), dtype=fdt, device=dev)
    uf = torch.zeros((B, Lp), dtype=fdt, device=dev)
    ur = torch.zeros((B, Lp), dtype=fdt, device=dev)
    for j in range(pwm_w):
        sj = _shift_left(seq, j, 0)
        cj = _shift_left(comp, pwm_w - 1 - j, 0)
        prod_f = prod_f * sel4_3d(cols[:, :, j, :], sj)
        prod_r = prod_r * sel4_3d(cols[:, :, j, :], cj)
        gcf = gcf + sel4_2d(gclp, sj)
        gcr = gcr + sel4_2d(gclp, cj)
        uf = uf + sel4_2d(ucols[:, j, :], sj)
        ur = ur + sel4_2d(ucols[:, j, :], cj)
    cmask = (torch.arange(C, device=dev)[None, :] < nm[:, None])[:, :, None]
    denom = torch.clamp(nm, min=1).to(fdt)[:, None]
    zero = torch.zeros((), dtype=fdt, device=dev)

    def class_sum(prod):
        """Masked sum over the C class PWMs, left to right (a fixed order
        on every device; csrc/frontend.cu adds in the same order)."""
        m = torch.where(cmask, prod, zero)
        acc = m[:, 0]
        for ci in range(1, C):
            acc = acc + m[:, ci]
        return acc

    mixf = class_sum(prod_f) / denom
    mixr = class_sum(prod_r) / denom
    is_user = bank["pwm_is_user"][gil][:, None]
    has_mix = (nm > 0)[:, None]
    sc_f = torch.where(is_user, uf, torch.log(mixf) - gcf)
    sc_r = torch.where(is_user, ur, torch.log(mixr) - gcr)
    return {"sc_f": sc_f, "sc_r": sc_r, "is_user": is_user,
            "has_mix": has_mix}


def _pwm_window_tables(pw, n, Lp: int, ws: int, W: int):
    """Per-position (score, sep) of the best RBS window for every possible
    start position, with the reference's strict-> first-max rule (smallest
    separation wins ties). Indexed by 0-based (pos - 1)."""
    any_mode = pw["is_user"] | pw["has_mix"]  # (B, 1)
    dev = n.device
    p0 = _ar(Lp, dev)[None, :]
    n2 = n[:, None]

    sc_f, sc_r = pw["sc_f"], pw["sc_r"]
    best_f = torch.full_like(sc_f, NEG_INF)
    sep_f = torch.zeros(sc_f.shape, dtype=I32, device=dev)
    best_r = torch.full_like(sc_f, NEG_INF)
    sep_r = torch.zeros(sc_f.shape, dtype=I32, device=dev)
    for s in range(ws - W + 1):
        # fwd: window start = p0 - W - s
        scf = _shift_right(sc_f, min(W + s, Lp), NEG_INF)
        tkf = (p0 - W - s >= 0) & any_mode & (scf > best_f)
        best_f = torch.where(tkf, scf, best_f)
        sep_f = torch.where(tkf, s, sep_f)
        # rev: window key p0 + 1 + s, valid while p0 + W + s < n
        scr = _shift_left(sc_r, min(s + 1, Lp), NEG_INF)
        tkr = (p0 + W + s < n2) & any_mode & (scr > best_r)
        best_r = torch.where(tkr, scr, best_r)
        sep_r = torch.where(tkr, s, sep_r)

    def fix(best, sep, user_zero):
        none = ~torch.isfinite(best)
        best = torch.where(none & user_zero, 0.0, best)
        sep = torch.where(none, 0, sep)
        return best, sep

    best_f, sep_f = fix(best_f, sep_f, pw["is_user"])
    best_r, sep_r = fix(best_r, sep_r, pw["is_user"])
    return {"bf": best_f, "sf": sep_f, "br": best_r, "sr": sep_r}


def _pwm_at(pwt, key_b, key_s, pos, fdt):
    """(pwm_score, sep) of starts at 1-based positions ``pos``."""
    if pwt is None:
        return (torch.zeros(pos.shape, dtype=fdt, device=pos.device),
                torch.zeros_like(pos))
    return (_gather_guard(pwt[key_b], pos - 1, 0.0),
            _gather_guard(pwt[key_s], pos - 1, 0))


def _add_pwm(score, pwm, sep):
    """Add_Events' separation-weighted RBS boost (glimmer_base.cc:267-295).
    The divisors are tensors on the score's device: PyTorch's CUDA kernel
    multiplies by the reciprocal of a Python-number divisor, which is not
    the true division the CPU (and csrc/frontend.cu) computes. They are
    filled on the device (``torch.full``), not copied from the host, which
    would synchronise the stream."""
    LO_SEP, HI_SEP, HI_TAIL = 4, 10, 6
    sepf = sep.to(score.dtype)

    def const(v):
        return torch.full((), v, dtype=score.dtype, device=score.device)

    coeff = torch.where(
        sep < LO_SEP, sepf / const(LO_SEP),
        torch.where(
            sep <= HI_SEP, torch.ones_like(sepf),
            torch.where(sep < HI_SEP + HI_TAIL,
                        (HI_SEP + HI_TAIL - sep).to(score.dtype)
                        / const(HI_TAIL), const(0.0))))
    add = (pwm >= 0.0) & (coeff > 0.0)
    return torch.where(add, score + coeff * pwm, score)


# ---------------------------------------------------------------------------
# Start-event candidates (Add_Events semantics, array form)
# ---------------------------------------------------------------------------


def _fold6(ex_raw, any_ev, slot6, tr_raw6, tr_final):
    """OR the 6 truncated-start columns into the slot-domain aggregates."""
    sNS = _ar(ex_raw.shape[1], ex_raw.device)[None, :]
    for k in range(6):
        hit = sNS == slot6[:, k:k + 1]
        ex_raw = ex_raw | (hit & tr_raw6[:, k:k + 1])
        any_ev = any_ev | (hit & tr_final[:, k:k + 1])
    return ex_raw, any_ev


def _dedup(std_pass, score, q, q_t, tr_pass, score_t):
    """A truncated first start and a std start at the same position: the
    truncated entry iterates first, the std entry replaces it only with a
    strictly greater score."""
    std_at = _gather_guard(std_pass, q_t, False)
    std_score = _gather_guard(score, q_t, NEG_INF)
    tr_final = tr_pass & ~(std_at & (std_score > score_t))
    kill_slot = tr_pass & (std_score <= score_t)
    kill = torch.zeros_like(std_pass)
    for k in range(q_t.shape[1]):
        kill = kill | ((q == q_t[:, k:k + 1]) & kill_slot[:, k:k + 1])
    return std_pass & ~kill, tr_final


def _score_tail(raw, prior, pwm, sep, len_tab, len_row, len_idx, which=None,
                start_lo3=None):
    """prior + RBS boost + start-codon log-odds + length log-odds."""
    score = _add_pwm(raw + prior, pwm, sep)
    if which is not None:
        start_sel = _sel3(start_lo3, which.clamp(0, 2)).to(score.dtype)
        score = torch.where(which >= 0, score + start_sel, score)
    return score + _gather2(len_tab, len_row, len_idx, 0.0)


def _group_tables(bank, gi, fdt):
    gil = gi.long()
    len_tab = bank["len_score"][gil].to(fdt)     # (B, 3, LN)
    return (bank["ignore_score_len"][gil][:, None],
            bank["prior"][gil].to(fdt)[:, None], len_tab,
            len_tab.shape[2], bank["start_lo"][gil])


def _start_candidates_fwd(t, fw, n, Lp, gi, bank, Sf, pw, consts, seq=None,
                          quals=None):
    """Forward-strand start-event candidates.

    Two families: one per read position q (the start codon's first base)
    and one 'truncated first start' per 5'-truncated forward ORF (the
    unconditional top-of-ORF start of Score_Orf_Starts,
    glimmer-mg.cc:1769-1800). Returns (std, tr, ex_raw, any_ev, subx):
    the families' event fields, the per-slot aggregates "some start's raw
    score beats start_threshold" and "some start became an event", and in
    substitution mode the sub-extension families (else None).
    """
    min_gene_len = consts["min_gene_len"]
    min_j = max(min(3, min_gene_len - 3), min_gene_len - 3)
    ev_thresh = consts["event_threshold"]
    fdt = Sf.dtype
    dev = n.device

    B = n.shape[0]
    n2 = n[:, None]
    q = _ar(Lp, dev)[None, :]
    c = (q + 2) % 3  # stop-subscript class of this position's chain
    i_next = _shift_left(t["nstop_f"], 5, BIG)  # nstop_f[q+5]
    ivirt = n2 + (q + 2 - n2) % 3
    iS = torch.minimum(i_next, ivirt)
    stop_m = t["is_fwd_stop"]
    vcls = (q + 2 - n2) % 3  # virtual-slot index of q's chain

    # slot -> member broadcast: per-slot values placed at their closing
    # stop (member q reads its run's stop at q+5), reverse-filled along
    # the class chain; the virtual tail is a 3-way select
    Vv = _shift_left(stop_m, 5, False)

    def prop(F):
        rf, anyv = _cls3_revfill(_shift_left(F[:, :Lp], 5, 0), Vv)
        return torch.where(anyv, rf, _sel3(F[:, Lp:], vcls))

    is_real = iS < n2
    emit = prop(fw["emit"])

    hi = iS - 2
    j3 = _ar(3, dev)[None, :]
    xv3 = n2 + j3 - 3
    fp3 = _gather_guard(t["fwd_prev"], xv3, 0)
    fp3 = torch.where(xv3 >= 0, fp3, xv3)      # fwd_prev_stop passthrough
    lo = torch.where(
        is_real, _shift_left(t["fwd_prev"], 2, 0), _sel3(fp3, vcls)) + 1
    mm = hi - lo
    top_j = torch.clamp(torch.div(mm - 1, 3, rounding_mode="floor") * 3,
                        min=-3)
    t3 = ~is_real

    j = hi - 3 - q
    hit2 = _shift_left(t["is_fwd_start"], 2, False)
    which = _shift_left(t["which_fwd"], 2, -1)
    std_valid = emit & (q >= lo) & (j >= min_j) & (j <= top_j) & hit2

    isl, prior, len_tab, LN, start_lo3 = _group_tables(bank, gi, fdt)

    # raw = Sf[c, iS-3] - Sf[c, q+2]: both ends read the class diagonal
    # R[x] = Sf[x%3, x]; the a-end is R at the closing stop (revfill)
    xm3 = q % 3
    R = torch.where(xm3 == 0, Sf[:, 0, :],
                    torch.where(xm3 == 1, Sf[:, 1, :], Sf[:, 2, :]))
    A_pos = _shift_right(R, 3, 0.0)             # A[p] = Sf[p%3, p-3]
    a_virt = _gather2(Sf, (n2 + j3) % 3, n2 + j3 - 3, 0.0)
    A_ext = torch.cat([A_pos, a_virt], dim=1)
    a = prop(A_ext)
    raw_nb = a - _shift_left(R, 2, 0.0)         # - Sf[c, q+2]
    raw = torch.where(j + 2 > isl, raw_nb.clamp(min=0.0), raw_nb)

    pos = (q + 3).expand(B, Lp)  # 1-based event position
    if pw is not None:
        pwm, sep = pw["bf"], pw["sf"]
    else:
        pwm = torch.zeros((B, Lp), dtype=fdt, device=dev)
        sep = torch.zeros((B, Lp), dtype=I32, device=dev)
    score = _score_tail(raw, prior, pwm, sep, len_tab,
                        torch.where(t3, 1, 0),
                        torch.clamp(torch.div(j, 3, rounding_mode="floor")
                                    + 1, 0, LN - 1),
                        which, start_lo3)
    std_pass = std_valid & (score > ev_thresh)

    # truncated first starts on a (B, 6) domain: 5'-truncation is only
    # possible for the FIRST ORF of each class chain plus the 3 virtual
    # end slots
    first_stop = t["nstop_f"][:, :3]
    has_first = first_stop < BIG // 2
    slot6 = torch.cat([torch.where(has_first, first_stop, -1),
                       (Lp + j3).expand(B, 3)], dim=1).to(I32)
    valid6 = torch.cat([has_first, torch.ones_like(has_first)], dim=1)
    slot6c = slot6.clamp(0, Lp + 2)

    def g6(arr):
        return torch.gather(arr, 1, slot6c.long())

    s_hi, s_mm, s_top = g6(fw["hi"]), g6(fw["mm"]), g6(fw["top_j"])
    s_trunc = g6(fw["orf_trunc"])
    tr_valid = (g6(fw["emit"]) & valid6 & s_trunc & (s_mm >= 1)
                & (s_top >= min_j))
    q_t = s_hi - 3 - s_top
    cS = g6(fw["iS"]) % 3
    raw_t_nb = (_gather2(Sf, cS, s_hi - 1, 0.0)
                - _gather2(Sf, cS, s_hi - 1 - s_top, 0.0))
    raw_t = torch.where(s_top + 2 > isl, raw_t_nb.clamp(min=0.0), raw_t_nb)
    pos_t = q_t + 3
    pwm_t, sep_t = _pwm_at(pw, "bf", "sf", pos_t - 2, fdt)
    score_t = _score_tail(
        raw_t, prior, pwm_t, sep_t, len_tab, torch.where(g6(fw["t3"]), 2, 1),
        torch.clamp(torch.div(s_top, 3, rounding_mode="floor") + 1, 0,
                    LN - 1))
    tr_pass = tr_valid & (score_t > ev_thresh)

    std_final, tr_final = _dedup(std_pass, score, q, q_t, tr_pass, score_t)

    # per-ORF aggregates over the start list, scatter-free: each ORF's
    # candidates are one contiguous class-strided run, so existence is a
    # difference of class prefix sums at the run boundaries
    thresh = consts["start_threshold"]
    xn3 = n2 + j3

    def seg_exists(ind):
        F = _cls3_cumsum(ind.to(I32))
        Fh = _shift_right(F, 5, 0)                  # F[x-5] at position x
        FFv, FFok = _cls3_fwdfill(torch.where(stop_m, Fh, 0), stop_m)
        FFz = torch.where(FFok, FFv, 0)
        ex_real = (Fh - _shift_right(FFz, 3, 0)) > 0
        ex_virt = (_sel3(F[:, Lp - 3:], (xn3 + 1) % 3)
                   - _sel3(FFz[:, Lp - 3:], xn3 % 3)) > 0
        return torch.cat([ex_real, ex_virt], dim=1)

    ex_raw, any_ev = _fold6(
        seg_exists(std_valid & (raw > thresh)), seg_exists(std_final), slot6,
        tr_valid & (raw_t > thresh), tr_final)

    std = {"valid": std_final, "pos": pos, "score": score,
           "trunc": torch.zeros((B, Lp), dtype=torch.bool, device=dev),
           "sub": ((c + 1) % 3).expand(B, Lp)}
    tr = {"valid": tr_final, "pos": pos_t, "score": score_t, "slot": slot6c,
          "trunc": torch.ones((B, 6), dtype=torch.bool, device=dev),
          "sub": (cS + 1) % 3}
    if not consts.get("subs"):
        return std, tr, ex_raw, any_ev, None

    # ---- substitution extension (Score_Orf_Starts' error branch,
    # glimmer-mg.cc:1769): a start of ORF s2 reads through s2's previous
    # stop s1 into s1's own run, so its candidates are this chain's
    # positions of run(s1) with suffix terms read from the NEXT slot ----
    lowest_j = min(3, min_gene_len - 3)
    posI = q.expand(B, Lp)
    rfp, okp = _cls3_revfill(torch.where(stop_m, posI, 0), stop_m)
    ns2 = _shift_left(torch.where(okp, rfp, 0), 3, 0)
    has_next = _shift_left(okp, 3, False)
    vclsx = (q - n2) % 3                      # virtual slot of x's class
    ns2_eff = torch.where(has_next, ns2, n2 + vclsx)
    mm2 = ns2_eff - q - 3                     # suffix length at x = s1

    def nxt(F):
        """Per-slot F (B, Lp + 3) of the next slot, read at a stop x."""
        z = _zero(F)
        G, ok = _cls3_revfill(torch.where(stop_m, F[:, :Lp], z), stop_m)
        Gv = _shift_left(torch.where(ok, G, z), 3, 0)
        return torch.where(_shift_left(ok, 3, False), Gv,
                           _sel3(F[:, Lp:], vclsx))

    emit2 = nxt(fw["emit"])
    a2 = nxt(A_ext)                           # Sf[c, hi(s2)-1] at x = s1
    t32 = ~has_next                           # s2 virtual <=> t3(s2)
    pen_pos = _stop_penalty(_shift_right(seq == 0, 1, False), seq == 0,
                            quals, True, fdt)
    suf_pos = pen_pos + (a2 - R)              # penalty + seg(s2)'s score

    def prop0(Fpos):
        rf, ok = _cls3_revfill(_shift_left(Fpos, 5, 0), Vv)
        return torch.where(ok, rf, _zero(Fpos))

    sj_q, suf_q, em2_q, t32_q = (prop0(x) for x in (mm2, suf_pos, emit2,
                                                     t32))
    min_j_sub = torch.clamp(min_gene_len - 3 - sj_q, min=lowest_j)
    jf = j + 2 + sj_q
    sub_valid = (is_real & em2_q & (q >= lo) & (j >= min_j_sub)
                 & (j <= top_j) & hit2 & (1 + jf >= min_gene_len))
    raw_tot = raw_nb + suf_q
    raw_tot = torch.where(jf > isl, raw_tot.clamp(min=0.0), raw_tot)
    score_sub = _score_tail(
        raw_tot, prior, pwm, sep, len_tab, torch.where(t32_q, 1, 0),
        torch.clamp(torch.div(j + sj_q, 3, rounding_mode="floor") + 1, 0,
                    LN - 1),
        which, start_lo3)
    sub_pass = sub_valid & (score_sub > ev_thresh)

    # truncated sub entries: a truncated segment 2 is the first run of a
    # class chain, so 3 columns at s1 = first_stop, credited to its next
    # slot s2
    def g3t(arr):
        return torch.gather(arr, 1, first_stop.clamp(0, Lp - 1).long())

    sjs6, sufs6, em26, t326 = (g3t(x) for x in (mm2, suf_pos, emit2, t32))
    s2slot6 = g3t(torch.where(has_next, ns2, Lp + vclsx))
    q_t3, s_top3 = q_t[:, :3], s_top[:, :3]
    minj6 = torch.clamp(min_gene_len - 3 - sjs6, min=lowest_j)
    jf6 = s_top3 + 2 + sjs6
    subtr_valid = (has_first & em26 & s_trunc[:, :3] & (s_mm[:, :3] >= 1)
                   & (s_top3 >= minj6) & (1 + jf6 >= min_gene_len))
    raw6 = raw_t_nb[:, :3] + sufs6
    raw6 = torch.where(jf6 > isl, raw6.clamp(min=0.0), raw6)
    score6 = _score_tail(
        raw6, prior, pwm_t[:, :3], sep_t[:, :3], len_tab,
        torch.where(t326, 2, 1),
        torch.clamp(torch.div(s_top3 + sjs6, 3, rounding_mode="floor") + 1,
                    0, LN - 1))
    subtr_pass = subtr_valid & (score6 > ev_thresh)
    sub_final, subtr_final = _dedup(sub_pass, score_sub, q, q_t3, subtr_pass,
                                    score6)

    # per-slot aggregates of the sub set: counted over run(s1), read at
    # s2 through its previous stop
    def prev_slot_read(Fpos):
        z = _zero(Fpos)
        FFv, FFok = _cls3_fwdfill(torch.where(stop_m, Fpos, z), stop_m)
        vals = torch.where(FFok, FFv, z)
        return torch.cat([_shift_right(vals, 3, 0),
                          _sel3(vals[:, Lp - 3:], xn3 % 3)], dim=1)

    ex_sub = prev_slot_read(seg_exists(sub_valid & (raw_tot > thresh))
                            [:, :Lp].to(I32)) > 0
    any_sub = prev_slot_read(seg_exists(sub_final)[:, :Lp].to(I32)) > 0
    sNS = _ar(Lp + 3, dev)[None, :]
    subtr_raw6 = subtr_valid & (raw6 > thresh)
    for k in range(3):
        hitk = (sNS == s2slot6[:, k:k + 1]) & has_first[:, k:k + 1]
        ex_sub = ex_sub | (hitk & subtr_raw6[:, k:k + 1])
        any_sub = any_sub | (hitk & subtr_final[:, k:k + 1])

    subx = {
        "fam_std": {"valid": sub_final, "pos": pos, "score": score_sub,
                    "trunc": std["trunc"], "sub": std["sub"],
                    "err_pos": (iS - 1).expand(B, Lp)},
        "fam_tr": {"valid": subtr_final, "pos": q_t3 + 3, "score": score6,
                   "trunc": torch.ones((B, 3), dtype=torch.bool, device=dev),
                   "sub": (cS[:, :3] + 1) % 3,
                   "err_pos": torch.where(has_first, first_stop - 1, -1)},
        "any_sub": any_sub, "any_clean": any_ev,
        "to_member": lambda F: prop(torch.cat(
            [nxt(F), _full(F, (B, 3), 0)], dim=1)),
        "s2slot6": s2slot6.clamp(0, Lp + 2), "s2slot6_valid": has_first,
        "err_pos_stop": prev_slot_read(posI) - 1,   # s1 - 1 per slot s2
    }
    return std, tr, ex_raw | ex_sub, any_ev | any_sub, subx


def _start_candidates_rev(t, rv, n, Lp, gi, bank, Sr, pw, consts, seq=None,
                          quals=None):
    """Reverse-strand start-event candidates (mirror of the forward case;
    candidate index u = the genome codon's LAST base of a reverse start).
    In substitution mode an ORF extends RIGHT through its closing stop
    into the next slot's run."""
    min_gene_len = consts["min_gene_len"]
    min_j = max(min(3, min_gene_len - 3), min_gene_len - 3)
    ev_thresh = consts["event_threshold"]
    fdt = Sr.dtype
    dev = n.device

    B = n.shape[0]
    n2 = n[:, None]
    u = _ar(Lp, dev)[None, :]
    c = u % 3
    i_close = _shift_left(t["nstop_r"], 3, BIG)  # nstop_r[u+3]
    is_real = i_close < BIG // 2
    stop_m = t["is_rev_stop"]

    # slot -> member broadcast (member u reads its closing stop at u+3);
    # the virtual tail selects by the static class c
    Vv = _shift_left(stop_m, 3, False)

    def prop(F):
        rf, anyv = _cls3_revfill(_shift_left(F[:, :Lp], 3, 0), Vv)
        return torch.where(anyv, rf, _sel3(F[:, Lp:], c))

    emit = prop(rv["emit"])

    # member-local slot fields: the ORF's previous stop is pstop_r[u]
    ip_m = t["pstop_r"]
    has_prev = ip_m > -BIG // 2
    vstop = torch.where(c == 0, -1, torch.where(c == 1, 0, -2)).to(I32)
    orf_stop = torch.where(has_prev, ip_m - 1, vstop)
    lo = orf_stop + 3
    x_ep = lo - 1
    f_r = (n2 - 1 - x_ep) % 3
    init_r = torch.where(f_r == 0, n2 - 1, torch.where(f_r == 1, n2 - 2, n2))
    rn = torch.minimum(init_r, torch.where(is_real, i_close - 2, BIG))
    inside = (x_ep >= 0) & (x_ep < n2)
    hi = torch.where(inside, rn, x_ep) + 1
    mm = hi - lo
    top_j = torch.clamp(torch.div(mm - 1, 3, rounding_mode="floor") * 3,
                        min=-3)
    t3 = orf_stop < 1

    j = u - lo - 1
    std_valid = (emit & t["is_rev_start"] & (j >= min_j) & (j <= top_j)
                 & (u <= hi - 2))
    which = t["which_rev"]

    isl, prior, len_tab, LN, start_lo3 = _group_tables(bank, gi, fdt)

    # raw = Sr[c, u-3] - (lo>=2 ? Sr[c, lo-2] : 0): the a-end is the class
    # diagonal shifted; the b-end is the diagonal at the member's previous
    # stop (forward fill), per-class constants when there is none
    Rr = torch.where(c == 0, Sr[:, 0, :],
                     torch.where(c == 1, Sr[:, 1, :], Sr[:, 2, :]))
    a = _shift_right(Rr, 3, 0.0)
    FF2v, FF2ok = _cls3_fwdfill(torch.where(stop_m, Rr, 0.0), stop_m)
    b_np = torch.stack(
        [Sr[:, 0, 0], Sr[:, 1, 1], torch.zeros_like(Sr[:, 0, 0])], dim=1)
    b = torch.where(FF2ok, FF2v, _sel3(b_np, c))
    raw_nb = a - b
    raw = torch.where(j + 2 > isl, raw_nb.clamp(min=0.0), raw_nb)

    pos = (u + 1).expand(B, Lp)  # REV_START event position
    if pw is not None:
        pwm, sep = pw["br"], pw["sr"]
    else:
        pwm = torch.zeros((B, Lp), dtype=fdt, device=dev)
        sep = torch.zeros((B, Lp), dtype=I32, device=dev)
    score = _score_tail(raw, prior, pwm, sep, len_tab,
                        torch.where(t3, 1, 0),
                        torch.clamp(torch.div(j, 3, rounding_mode="floor")
                                    + 1, 0, LN - 1),
                        which, start_lo3)
    std_pass = std_valid & (score > ev_thresh)

    # truncated entries on a (B, 6) domain: 3'-truncation is only possible
    # for the LAST ORF of each class chain plus the 3 end slots
    j3 = _ar(3, dev)[None, :]
    last_stop = t["pstop_r"][:, Lp - 3:]
    has_last = last_stop > -BIG // 2
    slot6 = torch.cat([torch.where(has_last, last_stop, -1),
                       (Lp + j3).expand(B, 3)], dim=1).to(I32)
    valid6 = torch.cat([has_last, torch.ones_like(has_last)], dim=1)
    slot6c = slot6.clamp(0, Lp + 2)

    def g6(arr):
        return torch.gather(arr, 1, slot6c.long())

    s_lo, s_mm, s_top = g6(rv["lo"]), g6(rv["mm"]), g6(rv["top_j"])
    s_trunc = g6(rv["orf_trunc"])
    tr_valid = (g6(rv["emit"]) & valid6 & s_trunc & (s_mm >= 1)
                & (s_top >= min_j))
    u_t = s_lo + s_top + 1
    cS = (s_lo + 1) % 3  # the ORF's stop-subscript class
    raw_t_nb = (_gather2(Sr, cS, s_lo - 2 + s_top, 0.0)
                - torch.where(s_lo >= 2, _gather2(Sr, cS, s_lo - 2, 0.0),
                              0.0))
    raw_t = torch.where(s_top + 2 > isl, raw_t_nb.clamp(min=0.0), raw_t_nb)
    pos_t = u_t + 1
    pwm_t, sep_t = _pwm_at(pw, "br", "sr", pos_t, fdt)
    score_t = _score_tail(
        raw_t, prior, pwm_t, sep_t, len_tab, torch.where(g6(rv["t3"]), 2, 1),
        torch.clamp(torch.div(s_top, 3, rounding_mode="floor") + 1, 0,
                    LN - 1))
    tr_pass = tr_valid & (score_t > ev_thresh)

    std_final, tr_final = _dedup(std_pass, score, u, u_t, tr_pass, score_t)

    # scatter-free aggregates: the rev run of slot s is the class-strided
    # (prev_stop-3, s-3]; virtual columns read the class-end scans
    thresh = consts["start_threshold"]

    def seg_exists(ind):
        F = _cls3_cumsum(ind.to(I32))
        Fh = _shift_right(F, 3, 0)                  # F[x-3] at position x
        FFv, FFok = _cls3_fwdfill(torch.where(stop_m, Fh, 0), stop_m)
        FFz = torch.where(FFok, FFv, 0)
        ex_real = (Fh - _shift_right(FFz, 3, 0)) > 0
        ex_virt = (F[:, Lp - 3:] - FFz[:, Lp - 3:]) > 0
        return torch.cat([ex_real, ex_virt], dim=1)

    ex_raw, any_ev = _fold6(
        seg_exists(std_valid & (raw > thresh)), seg_exists(std_final), slot6,
        tr_valid & (raw_t > thresh), tr_final)

    cslot6 = torch.where(slot6c < Lp, slot6c % 3, slot6c - Lp)
    std = {"valid": std_final, "pos": pos, "score": score,
           "trunc": torch.zeros((B, Lp), dtype=torch.bool, device=dev),
           "sub": (3 + (c + 1) % 3).expand(B, Lp)}
    tr = {"valid": tr_final, "pos": pos_t, "score": score_t, "slot": slot6c,
          "trunc": torch.ones((B, 6), dtype=torch.bool, device=dev),
          "sub": 3 + (cslot6 + 1) % 3}
    if not consts.get("subs"):
        return std, tr, ex_raw, any_ev, None

    # ---- substitution extension, reverse strand: ORF s2 extends RIGHT
    # past its closing stop s into the NEXT slot's run; every member value
    # of s2 is a class forward-fill read at the member's previous stop ----
    lowest_j = min(3, min_gene_len - 3)

    def prevread(Fpos):
        z = _zero(Fpos)
        FFx, FFxok = _cls3_fwdfill(torch.where(stop_m, Fpos, z), stop_m)
        return torch.where(FFxok, FFx, z)

    emit2_u = prevread(rv["emit"][:, :Lp])
    sj_u = prevread(rv["mm"][:, :Lp])
    t32_u = prevread(rv["t3"][:, :Lp])
    total_pos = a - _shift_right(b, 3, 0.0)    # seg(s2)'s score at s
    pen_pos = _stop_penalty(_shift_right(seq == 3, 1, False),
                            _shift_right(seq == 3, 2, False), quals, False,
                            fdt)
    suf_pos = pen_pos + total_pos
    suf_u = prevread(suf_pos)

    min_j_sub = torch.clamp(min_gene_len - 3 - sj_u, min=lowest_j)
    jf = j + 2 + sj_u
    sub_valid = (has_prev & emit2_u & t["is_rev_start"] & (j >= min_j_sub)
                 & (j <= top_j) & (u <= hi - 2) & (1 + jf >= min_gene_len))
    raw_tot = raw_nb + suf_u
    raw_tot = torch.where(jf > isl, raw_tot.clamp(min=0.0), raw_tot)
    score_sub = _score_tail(
        raw_tot, prior, pwm, sep, len_tab, torch.where(t32_u, 1, 0),
        torch.clamp(torch.div(j + sj_u, 3, rounding_mode="floor") + 1, 0,
                    LN - 1),
        which, start_lo3)
    sub_pass = sub_valid & (score_sub > ev_thresh)

    # truncated sub entries: a truncated segment 2 is exactly one of the
    # 6 tr columns (its s3); s2 is each one's PREVIOUS slot
    pp3 = _gather_guard(t["pstop_r"], last_stop.clamp(0, Lp - 1) - 3, -BIG)
    pp3ok = has_last & (pp3 > -BIG // 2)
    s2slot6 = torch.cat([torch.where(pp3ok, pp3, 0),
                         torch.where(has_last, last_stop, 0)], dim=1)
    s2ok6 = torch.cat([pp3ok, has_last], dim=1)

    def g6s(arr):
        return torch.gather(arr, 1, s2slot6.long())

    emit26 = g6s(rv["emit"]) & s2ok6
    sjs6, t326 = g6s(rv["mm"]), g6s(rv["t3"])
    suf6 = _gather_guard(suf_pos, s2slot6, 0.0)
    minj6 = torch.clamp(min_gene_len - 3 - sjs6, min=lowest_j)
    jf6 = s_top + 2 + sjs6
    subtr_valid = (s2ok6 & emit26 & s_trunc & (s_mm >= 1)
                   & (s_top >= minj6) & (1 + jf6 >= min_gene_len))
    raw6 = raw_t_nb + suf6
    raw6 = torch.where(jf6 > isl, raw6.clamp(min=0.0), raw6)
    score6 = _score_tail(
        raw6, prior, pwm_t, sep_t, len_tab, torch.where(t326, 2, 1),
        torch.clamp(torch.div(s_top + sjs6, 3, rounding_mode="floor") + 1,
                    0, LN - 1))
    subtr_pass = subtr_valid & (score6 > ev_thresh)
    sub_final, subtr_final = _dedup(sub_pass, score_sub, u, u_t, subtr_pass,
                                    score6)

    # per-slot sub aggregates: counted over run(s3), read at slot s2
    # through the next-slot relation; virtual s3 through the class columns
    def nxt_r(F):
        z = _zero(F)
        G, ok = _cls3_revfill(torch.where(stop_m, F[:, :Lp], z), stop_m)
        Gv = _shift_left(torch.where(ok, G, z), 3, 0)
        part = torch.where(_shift_left(ok, 3, False), Gv,
                           _sel3(F[:, Lp:], c.expand(B, Lp)))
        return torch.cat([part, _full(part, (B, 3), 0)], dim=1)

    ex_sub = nxt_r(seg_exists(sub_valid & (raw_tot > thresh)))
    any_sub = nxt_r(seg_exists(sub_final))
    sNS = _ar(Lp + 3, dev)[None, :]
    subtr_raw6 = subtr_valid & (raw6 > thresh)
    for k in range(6):
        hit = (sNS == s2slot6[:, k:k + 1]) & s2ok6[:, k:k + 1]
        ex_sub = ex_sub | (hit & subtr_raw6[:, k:k + 1])
        any_sub = any_sub | (hit & subtr_final[:, k:k + 1])

    subx = {
        "fam_std": {"valid": sub_final, "pos": pos, "score": score_sub,
                    "trunc": std["trunc"], "sub": std["sub"],
                    "err_pos": ip_m + 1},
        "fam_tr": {"valid": subtr_final, "pos": pos_t, "score": score6,
                   "trunc": tr["trunc"], "sub": tr["sub"],
                   "err_pos": torch.where(s2ok6, s2slot6 + 1, -1)},
        "any_sub": any_sub, "any_clean": any_ev,
        "to_member": lambda F: prevread(F[:, :Lp]),
        "s2slot6": s2slot6.clamp(0, Lp + 2), "s2slot6_valid": s2ok6,
        "err_pos_stop": (sNS + 1).expand(B, Lp + 3),  # rev error at s + 1
    }
    return std, tr, ex_raw | ex_sub, any_ev | any_sub, subx


# ---------------------------------------------------------------------------
# Event ids and assembly
# ---------------------------------------------------------------------------


def _assign_ids(fw, rv, evprod_f, evprod_r, Lp, sub_f, sub_r):
    """Event-set ids: rank of each (ORF, error set) in the reference's
    processing order (the ids of the .predict orfNNNNN column). Returns
    (clean fwd, clean rev, sub fwd, sub rev) ids; ``sub_f``/``sub_r``
    are all False in error-free mode.

    Add_Events gives one id per error set present, in the order of each
    set's first event position: the forward sub-extended set lies LEFT of
    the clean segment (ranked first), the reverse one RIGHT of it (ranked
    last). The scatter adds duplicates, like JAX's ``.at[].add``."""
    B = evprod_f.shape[0]
    kf = (fw["key"] * 2).long()
    kr = (rv["key"] * 2).long()
    keyarr = torch.zeros((B, 4 * Lp + 32), dtype=I32, device=kf.device)
    keyarr.scatter_add_(1, kf, sub_f.to(I32))
    keyarr.scatter_add_(1, kf + 1, evprod_f.to(I32))
    keyarr.scatter_add_(1, kr, evprod_r.to(I32))
    keyarr.scatter_add_(1, kr + 1, sub_r.to(I32))
    ranks = torch.cumsum(keyarr, dim=1).to(I32)
    return (torch.gather(ranks, 1, kf + 1), torch.gather(ranks, 1, kr),
            torch.gather(ranks, 1, kf), torch.gather(ranks, 1, kr + 1))


def _assemble_events(fam, max_events, ties=False):
    """Sort candidate families into the padded per-read event tensor.

    Error-free order: position, then family enumeration order
    (concatenation order), so a stable sort on position alone gives
    pos-then-rank. With ``ties`` (substitution mode) equal positions keep
    the reference's event insertion order, each family's ``tiekey`` (ORF
    processing rank and phase within the ORF): two stable sorts, the
    tiekey first, then the position. Families with ``err_pos`` carry
    ``err_pos``/``err_typ`` into the events.
    """
    def cat(key):
        return torch.cat([f[key] for f in fam], dim=-1)

    valid = cat("valid")
    pos = cat("pos").to(I32)
    if ties:
        p1 = torch.argsort(torch.where(valid, cat("tiekey").to(I32), 2**30),
                           dim=-1, stable=True)
        pos_p = torch.gather(pos, -1, p1)
        valid_p = torch.gather(valid, -1, p1)
        p2 = torch.argsort(torch.where(valid_p, pos_p, 2**30), dim=-1,
                           stable=True)
        order = torch.gather(p1, -1, p2)[..., :max_events]
    else:
        sort_key = torch.where(valid, pos, 2**30)
        order = torch.argsort(sort_key, dim=-1, stable=True)[..., :max_events]

    def g(a):
        return torch.gather(a, -1, order)

    ev = {
        "pos": g(pos),
        "typ": torch.where(g(valid), g(cat("typ").to(I32)), 0).to(I32),
        "sub": g(cat("sub").to(I32)),
        "id": g(cat("id").to(I32)),
        "score": g(cat("score")),
        "trunc": g(cat("trunc")),
    }
    if "err_pos" in fam[0]:
        ev["err_pos"] = g(cat("err_pos").to(I32))
        ev["err_typ"] = g(cat("err_typ").to(I32))
    n_events = torch.sum(valid.to(I32), dim=-1).to(I32)
    return ev, n_events


def frontend(seq, n, gi, gene6, ind6, bank, Lp: int, consts, max_events,
             quals=None):
    """Batched candidate construction: ORF slots, start scoring, event
    assembly (everything before the event DP). seq (B, Lp), n/gi (B,),
    gene6/ind6 (B, 6, Lp), quals (B, Lp) uint8 per-base qualities of the
    substitution mode (``consts["subs"]``) or None. Returns (ev of (B, E)
    tensors, n_events (B,))."""
    B = seq.shape[0]
    dev = seq.device
    fdt = consts["fdt"]
    subs = bool(consts.get("subs"))
    t = _read_tables(seq, n, gi, bank)
    fw = _fwd_orf_slots(t, n, Lp, consts["min_gene_len"], indel_orfs=subs)
    rv = _rev_orf_slots(t, n, Lp, consts["min_gene_len"], indel_orfs=subs)
    Sf, Sr = _frame_prefix_sums(gene6, ind6, n, Lp, fdt)
    pw = None
    if consts["W"]:
        pw = _pwm_window_tables(_pwm_arrays(seq, gi, bank, consts["W"], fdt),
                                n, Lp, consts["ws"], consts["W"])

    std_f, tr_f, braw_f, anyev_f, subx_f = _start_candidates_fwd(
        t, fw, n, Lp, gi, bank, Sf, pw, consts, seq, quals)
    std_r, tr_r, braw_r, anyev_r, subx_r = _start_candidates_rev(
        t, rv, n, Lp, gi, bank, Sr, pw, consts, seq, quals)
    evprod_f = fw["emit"] & braw_f & anyev_f
    evprod_r = rv["emit"] & braw_r & anyev_r
    if subs:
        # each (ORF, error set) present gets its own id and stop event
        sub_ind_f = evprod_f & subx_f["any_sub"]
        sub_ind_r = evprod_r & subx_r["any_sub"]
        stop_f_valid = evprod_f & subx_f["any_clean"]
        stop_r_valid = evprod_r & subx_r["any_clean"]
    else:
        sub_ind_f = torch.zeros_like(evprod_f)
        sub_ind_r = torch.zeros_like(evprod_r)
        stop_f_valid, stop_r_valid = evprod_f, evprod_r
    id_f, id_r, id_sf, id_sr = _assign_ids(
        fw, rv, stop_f_valid, stop_r_valid, Lp, sub_ind_f, sub_ind_r)

    n_slots = Lp + 3
    idx_slots = _ar(n_slots, dev)[None, :]
    cslot_r = torch.where(idx_slots < Lp, idx_slots % 3, idx_slots - Lp)
    zsc = torch.zeros((B, n_slots), dtype=fdt, device=dev)
    zb = torch.zeros((B, n_slots), dtype=torch.bool, device=dev)

    def taa(a, i):
        return torch.gather(a, 1, i.long())

    # slot -> member propagation of the per-ORF gate and id
    q = _ar(Lp, dev)[None, :]

    def prop_mk(stop_mask, shift, vsel):
        Vv = _shift_left(stop_mask, shift, False)

        def prop(F):
            rf, anyv = _cls3_revfill(_shift_left(F[:, :Lp], shift, 0), Vv)
            return torch.where(anyv, rf, _sel3(F[:, Lp:], vsel))
        return prop

    prop_f = prop_mk(t["is_fwd_stop"], 5, (q + 2 - n[:, None]) % 3)
    prop_r = prop_mk(t["is_rev_stop"], 3, (q % 3).expand(B, Lp))

    def typ(code, w):
        return torch.full((B, w), code, dtype=I32, device=dev)

    sub_fs = (fw["iS"] % 3 + 1) % 3
    sub_rs = (3 + (cslot_r + 1) % 3).expand(B, n_slots)
    fam_f = [
        dict(std_f, valid=std_f["valid"] & prop_f(evprod_f),
             typ=typ(E_FWD_START, Lp), id=prop_f(id_f)),
        dict(tr_f, valid=tr_f["valid"] & taa(evprod_f, tr_f["slot"]),
             typ=typ(E_FWD_START, 6), id=taa(id_f, tr_f["slot"])),
        dict(valid=stop_f_valid, pos=fw["stop_pos"] + 2, score=zsc,
             sub=sub_fs, typ=typ(E_FWD_STOP, n_slots), id=id_f, trunc=zb),
    ]
    fam_r = [
        dict(std_r, valid=std_r["valid"] & prop_r(evprod_r),
             typ=typ(E_REV_START, Lp), id=prop_r(id_r)),
        dict(tr_r, valid=tr_r["valid"] & taa(evprod_r, tr_r["slot"]),
             typ=typ(E_REV_START, 6), id=taa(id_r, tr_r["slot"])),
        dict(valid=stop_r_valid, pos=rv["stop_pos"] + 2, score=zsc,
             sub=sub_rs, typ=typ(E_REV_STOP, n_slots), id=id_r, trunc=zb),
    ]
    if not subs:
        return _assemble_events(fam_f + fam_r, max_events)

    # within-ORF insertion phases for the equal-position order: forward
    # inserts starts then stops, reverse stops then starts; a stop pair
    # goes clean before sub
    kf4, kr4 = fw["key"] * 4, rv["key"] * 4
    for f, tk in zip(fam_f, (prop_f(kf4) + 1, taa(kf4, tr_f["slot"]) + 1,
                             kf4 + 2)):
        f["tiekey"] = tk
    for f, tk in zip(fam_r, (prop_r(kr4) + 2, taa(kr4, tr_r["slot"]) + 2,
                             kr4)):
        f["tiekey"] = tk

    def sub_fams(subx, evprod, id_s, k4, phase, typ_code):
        """The sub-extension start families of one strand."""
        to_m, s2 = subx["to_member"], subx["s2slot6"]
        fs, ft = subx["fam_std"], subx["fam_tr"]
        return [
            dict(fs, valid=fs["valid"] & to_m(evprod),
                 typ=typ(typ_code, fs["pos"].shape[1]), id=to_m(id_s),
                 err_typ=ERR_SUB, tiekey=to_m(k4) + phase),
            dict(ft, valid=ft["valid"] & subx["s2slot6_valid"]
                 & taa(evprod, s2),
                 typ=typ(typ_code, ft["pos"].shape[1]), id=taa(id_s, s2),
                 err_typ=ERR_SUB, tiekey=taa(k4, s2) + phase),
        ]

    def sub_stop(subx, sub_ind, slots, sub, id_s, tiekey, typ_code):
        return dict(valid=sub_ind, pos=slots["stop_pos"] + 2, score=zsc,
                    sub=sub, typ=typ(typ_code, n_slots), id=id_s, trunc=zb,
                    err_pos=subx["err_pos_stop"], err_typ=ERR_SUB,
                    tiekey=tiekey)

    # the reverse sub events belong to the PREVIOUS slot (processed first
    # in the reference's ORF order), so at equal positions they enumerate
    # before the clean families
    fams = (fam_f[:2] + sub_fams(subx_f, evprod_f, id_sf, kf4, 1,
                                 E_FWD_START)
            + [fam_f[2], sub_stop(subx_f, sub_ind_f, fw, sub_fs, id_sf,
                                  kf4 + 3, E_FWD_STOP)]
            + sub_fams(subx_r, evprod_r, id_sr, kr4, 2, E_REV_START)
            + fam_r + [sub_stop(subx_r, sub_ind_r, rv, sub_rs, id_sr,
                                kr4 + 1, E_REV_STOP)])
    for f in fams:
        w = f["pos"].shape[1]
        f.setdefault("err_pos", torch.full((B, w), -1, dtype=I32, device=dev))
        f["err_typ"] = torch.full((B, w), f.get("err_typ", -1), dtype=I32,
                                  device=dev)
    return _assemble_events(fams, max_events, ties=True)
