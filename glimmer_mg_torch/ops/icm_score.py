"""Plain PyTorch ICM walks: the exact walk and the twins of the CUDA kernels.

Counterpart of ``glimmer_mg_tpu.ops.icm_score``. The 11-base context
window of each position is packed into one int32 (2 bits per base, window
position w at bits 2w..2w+1), so a walk step
``child = 4*node + base[ctx_pos[node]] + 1`` is one table read
(``mip[node]``) plus shifts on the packed integer. The walk is unrolled
``depth`` times with masks; partial windows at the start of a sequence
fall out of a per-position threshold.

Two paths use it:
  * per-read prediction: ``mg_six_frame_batch``, the twin of the six-frame
    kernel ``csrc/six_frame.cu``. Every output value is a table read with
    no float arithmetic, so it is bitwise equal to the JAX walk and to the
    kernel;
  * Phymm classification: ``bank_score_reads``, the exact f32 walk, and
    ``bank_score_reads_packed``, the twin of the bank-walk kernel
    ``csrc/bank_walk.cu`` over the 16-bit fixed-point tables of
    ``icm_cuda.pack_tables`` or the 8-bit ones of
    ``icm_cuda.pack_tables_int8``. The twin sums integers, so it is
    bitwise equal to the kernel, and to the Pallas kernel while every
    partial f32 sum of the scaled values is exact (|score| < 65,536 for
    16 bits, always for 8 bits at scale 8).

``ops/icm_cuda.py`` calls the twins for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_contexts(base_idx: torch.Tensor, model_len: int) -> torch.Tensor:
    """Packed 2-bit context windows along the last axis.

    ``ctx[i]`` holds bases at positions ``i-(model_len-1) .. i-1`` in bits
    ``0..2*(model_len-1)-1`` (window position w at bits 2w..2w+1).
    Positions before the sequence start read as zeros; callers mask them
    with the threshold.
    """
    w = model_len - 1
    s = base_idx.to(torch.int32)
    n = s.shape[-1]
    padded = torch.cat([s.new_zeros(s.shape[:-1] + (w,)), s], dim=-1)
    ctx = torch.zeros_like(s)
    for k in range(w):
        # window position k of ctx[i] = s[i - w + k] = padded[i + k]
        ctx = ctx | (padded[..., k:k + n] << (2 * k))
    return ctx


def _tree_walk(mip_flat, depth: int, base_off, ctx, thresh):
    """Masked unrolled walk; returns the final node index per position.

    ``mip_flat`` is the flattened int32 mut_info_pos table, ``base_off``
    the per-position flat offset of the (model, frame) table.
    """
    node = torch.zeros_like(ctx)
    done = torch.zeros(ctx.shape, dtype=torch.bool, device=ctx.device)
    for _ in range(depth):
        pos = mip_flat[(base_off + node).long()]
        avail = pos >= thresh
        b = (ctx >> (2 * pos.clamp(min=0))) & 3
        child = 4 * node + b + 1
        node = torch.where(done | ~avail, node, child)
        done = done | ~avail
    # landed on a pruned node (mip == -2): back up to the parent
    pos = mip_flat[(base_off + node).long()]
    parent = torch.div(node - 1, 4, rounding_mode="floor")
    return torch.where(pos == -2, parent, node)


def _cycle_fields(seq, model_len: int, periodicity: int, frame0: int = 0,
                  cycle: bool = True):
    """Per-position (ctx, thresh, frame) of sequences along the last axis;
    with ``cycle`` the frame advances per base (Score_String), else it
    stays ``frame0`` (Frame_Score)."""
    n = seq.shape[-1]
    i = torch.arange(n, dtype=torch.int32, device=seq.device)
    thresh = ((model_len - 1) - i).clamp(min=0)
    frame = (frame0 + i) % periodicity if cycle else \
        torch.full_like(i, frame0 % periodicity)
    return pack_contexts(seq, model_len), thresh, frame


def _model_logprob(mip32, probs, seq, ctx, thresh, frame, depth: int):
    """Per-position log-probs under one ICM (``mip32`` (P, N) int32)."""
    base_off = frame * mip32.shape[1]
    node = _tree_walk(mip32.reshape(-1), depth, base_off, ctx, thresh)
    return probs.reshape(-1)[((base_off + node) * 4 + seq).long()]


def per_base_logprob(mip, probs, base_idx, frame0: int, model_len: int,
                     depth: int, cycle: bool = True):
    """Per-base log-probs of sequences (last axis) under one ICM.

    mip (P, N) int, probs (P, N, 4) f32, base_idx (..., L) int. Table
    reads only, so bitwise equal to
    ``glimmer_mg_tpu.ops.icm_score.per_base_logprob``.
    """
    seq = base_idx.to(torch.int32)
    ctx, thresh, frame = _cycle_fields(seq, model_len, mip.shape[0], frame0,
                                       cycle)
    return _model_logprob(mip.to(torch.int32), probs, seq, ctx, thresh,
                          frame, depth)


def score_string(mip, probs, base_idx, frame0: int, model_len: int,
                 depth: int):
    """Total log-prob (f32 sum) of a sequence, frame cycling."""
    return per_base_logprob(mip, probs, base_idx, frame0, model_len,
                            depth).sum(dim=-1)


def cumulative_score(mip, probs, base_idx, frame0: int, model_len: int,
                     depth: int):
    """Running f32 total of the per-base log-probs, frame cycling,
    flattened as ``jnp.cumsum`` flattens (a 1-D sequence stays 1-D)."""
    return torch.cumsum(per_base_logprob(mip, probs, base_idx, frame0,
                                         model_len, depth).reshape(-1), dim=0)


def bank_score_reads(bank_mip, bank_probs, reads, lengths, model_len: int,
                     depth: int):
    """(B, M) total f32 log-prob of each padded read under each bank ICM,
    frame 0 at base 0, cycling (the exact classification walk).

    bank_mip (M, P, N) int, bank_probs (M, P, N, 4) f32, reads (B, L) int,
    lengths (B,). One model at a time.
    """
    seq = reads.to(torch.int32)
    ctx, thresh, frame = _cycle_fields(seq, model_len, bank_mip.shape[1])
    valid = (torch.arange(seq.shape[1], device=seq.device)[None, :]
             < lengths[:, None])
    mip32 = bank_mip.to(torch.int32)
    out = torch.empty((seq.shape[0], bank_mip.shape[0]), dtype=torch.float32,
                      device=seq.device)
    for k in range(bank_mip.shape[0]):
        per = _model_logprob(mip32[k], bank_probs[k], seq, ctx, thresh, frame,
                             depth)
        out[:, k] = torch.where(valid, per, 0.0).sum(dim=1)
    return out


def bank_score_reads_packed(level_mip, probs_pk, reads, lengths,
                            model_len: int, depth: int, int8: bool = False,
                            scale: float = 256.0):
    """(B, M) fixed-point total log-prob of each read under each bank ICM:
    the twin of the bank-walk kernel (``csrc/bank_walk.cu``) and of the
    Pallas ``_walk_kernel`` plus its wrapper's masked sum.

    level_mip (M, 3, LR, 128) int32 and probs_pk are ``icm_cuda.
    pack_tables`` output (probs_pk (M, 3, R2, 128) int32, two int16
    values per entry) or, with ``int8``, ``icm_cuda.pack_tables_int8``
    output (probs_pk (M, 3, R, 128) int32, four int8 values per entry);
    reads (B, L) int, lengths (B,). Position i uses frame i % 3 and walks
    ``depth`` levels, level k reading ``level_mip[m, f, off_k + (o >> 7),
    o & 127]`` with ``o = node - (4^k - 1)/3``. Its value is the int16
    half ``last & 1`` of ``probs_pk[m, f, (node >> 7)*2 + (last >> 1),
    node & 127]``, or with ``int8`` the byte ``last`` of
    ``probs_pk[m, f, node >> 7, node & 127]``. Positions at or past a
    read's length are masked, the values summed as integers and scaled
    once by 1/scale (``icm_cuda.FIXED_SCALE`` for 16-bit tables, the
    scale ``pack_tables_int8`` returns for 8-bit ones).
    """
    from .icm_cuda import LANES, _level_rows

    m, p, lr, _lanes = level_mip.shape
    r2 = probs_pk.shape[2]
    seq = reads.to(torch.int32)
    ctx, thresh, frame = _cycle_fields(seq, model_len, p)
    valid = (torch.arange(seq.shape[1], device=seq.device)[None, :]
             < lengths[:, None])
    row_off = np.cumsum([0] + _level_rows(depth)).tolist()
    lm_flat = level_mip.reshape(-1)
    pk_flat = probs_pk.reshape(-1)
    frame64 = frame.long()
    lo = (seq >> 1) * LANES
    high_half = (seq & 1) == 1
    byte_shift = 8 * seq
    out = torch.empty((seq.shape[0], m), dtype=torch.float32,
                      device=seq.device)
    for k in range(m):
        tab = (k * p + frame64) * (lr * LANES)  # (L,) the position's table
        node = torch.zeros_like(ctx)
        done = torch.zeros(ctx.shape, dtype=torch.bool, device=ctx.device)
        for lev in range(depth):
            o = node - (4 ** lev - 1) // 3
            idx = torch.where(done, tab, tab + row_off[lev] * LANES + o)
            pos = lm_flat[idx]
            avail = pos >= thresh
            b = (ctx >> (2 * pos.clamp(min=0))) & 3
            node = torch.where(done | ~avail, node, 4 * node + b + 1)
            done = done | ~avail
        ptab = (k * p + frame64) * (r2 * LANES)
        if int8:
            acc = pk_flat[ptab + node]
            byte = (acc >> byte_shift) & 0xFF
            val = (byte ^ 0x80) - 0x80
        else:
            acc = pk_flat[ptab + (node >> 7) * (2 * LANES) + lo
                          + (node & (LANES - 1))]
            val = torch.where(high_half, acc >> 16,
                              ((acc & 0xFFFF) ^ 0x8000) - 0x8000)
        total = torch.where(valid, val, 0).sum(dim=1)
        out[:, k] = total.to(torch.float32) * (1.0 / scale)
    return out


def revcomp_reads(reads, lengths):
    """Reverse complement of padded reads (the pad stays at the tail)."""
    l = reads.shape[1]
    i = torch.arange(l, device=reads.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    comp = 3 - reads  # a<->t, c<->g in index space
    rc = torch.gather(comp, 1, (lens - 1 - i) % l)
    return torch.where(i < lens, rc, 0)


def _banked_logprob(mip_flat, probs_flat, num_nodes: int, periodicity: int,
                    goff, seq, frame0: int, model_len: int, depth: int):
    """Fixed-frame per-position log-probs of (B, L) sequences, each under
    its own bank entry (``goff`` (B, 1) = g * periodicity * num_nodes)."""
    n = seq.shape[-1]
    ctx = pack_contexts(seq, model_len)
    i = torch.arange(n, dtype=torch.int32, device=seq.device)
    thresh = ((model_len - 1) - i).clamp(min=0)
    base_off = goff + (frame0 % periodicity) * num_nodes
    node = _tree_walk(mip_flat, depth, base_off, ctx, thresh)
    last = seq.to(torch.int32)
    return probs_flat[((base_off + node) * 4 + last).long()]


def read_variants(reads: torch.Tensor, lengths: torch.Tensor):
    """(rev, comp) int32 variants of padded reads: ``rev[i] =
    read[len-1-i]`` and ``comp[i] = 3 - read[i]`` for ``i < len``, else 0."""
    b, l = reads.shape
    reads32 = reads.to(torch.int32)
    i = torch.arange(l, dtype=torch.int32, device=reads.device)[None, :]
    lens = lengths.to(torch.int32)[:, None]
    ridx = lens - 1 - i
    rev = torch.where(
        ridx >= 0, torch.gather(reads32, 1, ridx.clamp(min=0).long()), 0
    ).to(torch.int32)
    comp = torch.where(i < lens, 3 - reads32, 0).to(torch.int32)
    return rev, comp


def mg_six_frame_batch(gene_mip, gene_probs, indep_mip, indep_probs, reads,
                       lengths, group, model_len: int = 12, depth: int = 7,
                       gene_periodicity: int = 3):
    """Batched Score_All_Frames table reads (reference glimmer-mg.cc:1468).

    gene_mip (G, P, N) int16/int32, gene_probs (G, P, N, 4) f32, indep_mip
    (G, 3, N2), indep_probs (G, 3, N2, 4), reads (B, L) int, lengths (B,),
    group (B,) bank index of each read. Returns (gene (B, 6, L) f32,
    indep (B, 6, L) f32): rows 0..2 are fixed frames 0..2 over the
    REVERSED read, rows 3..5 frames 0..2 over the COMPLEMENTED read.
    """
    _g, p, n_nodes = gene_mip.shape
    gm_flat = gene_mip.reshape(-1).to(torch.int32)
    gp_flat = gene_probs.reshape(-1)
    im_flat = indep_mip.reshape(-1).to(torch.int32)
    ip_flat = indep_probs.reshape(-1)
    n2 = indep_mip.shape[2]

    rev, comp = read_variants(reads, lengths)
    gi = group.to(torch.int32)[:, None]
    goff_g = gi * p * n_nodes
    goff_i = gi * 3 * n2
    gout, iout = [], []
    for seq in (rev, comp):
        for f in range(3):
            gout.append(_banked_logprob(gm_flat, gp_flat, n_nodes,
                                        gene_periodicity, goff_g, seq, f,
                                        model_len, depth))
            iout.append(_banked_logprob(im_flat, ip_flat, n2, 3, goff_i, seq,
                                        f, 3, 2))
    return torch.stack(gout, dim=1), torch.stack(iout, dim=1)


def stack_bank(icms) -> tuple[np.ndarray, np.ndarray]:
    """Stack a list of ICM dataclasses into bank tables, padding num_nodes
    (numpy; the same tables as ``glimmer_mg_tpu.ops.icm_score.stack_bank``)."""
    n = max(m.num_nodes for m in icms)
    p = icms[0].periodicity
    mip = np.full((len(icms), p, n), -1, dtype=np.int16)
    probs = np.zeros((len(icms), p, n, 4), dtype=np.float32)
    for i, m in enumerate(icms):
        mip[i, :, : m.num_nodes] = m.mip
        probs[i, :, : m.num_nodes] = m.probs
    return mip, probs
