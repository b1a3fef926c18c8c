"""Plain PyTorch six-frame ICM walk (the twin of the CUDA kernel).

Counterpart of ``glimmer_mg_tpu.ops.icm_score`` for the per-read
prediction path. The 11-base context window of each position is packed
into one int32 (2 bits per base, window position w at bits 2w..2w+1), so
a walk step ``child = 4*node + base[ctx_pos[node]] + 1`` is one table read
(``mip[node]``) plus shifts on the packed integer. The walk is unrolled
``depth`` times with masks; partial windows at the start of a sequence
fall out of a per-position threshold.

Every output value is a table read with no float arithmetic, so the
results are bitwise equal to the JAX walk and to the CUDA kernel in
``ops/icm_cuda.py``, which calls this module for CPU tensors.
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
