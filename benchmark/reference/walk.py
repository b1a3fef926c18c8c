# The walk follows glimmer_mg_torch/ops/icm_score.py at commit ab5a5d3
# (pack_contexts, read_variants, _tree_walk, _cycle_fields), rewritten to
# score every model of a bank at once and to add in float64.
"""The exact ICM walk of Phymm classification, in plain PyTorch.

A read's score under an ICM is the sum over its positions of the log-prob
of the base given its context, frame cycling from 0 at base 0, the walk
entering a child while the node's mut_info_pos is at least model_len - 1 -
i and backing up from a pruned node to its parent; a read's classification
score is the larger of its two strands' (simple-score -N,
scoreReadsGlim.pl). The tables come from the ICM files, read by the
frozen reader.
"""

from __future__ import annotations

import numpy as np
import torch

from .gm.models.icm import read_icm


def pack_contexts(seq, model_len):
    """``ctx[..., i]``: bases i-(model_len-1) .. i-1 in bits 0.. (window
    position w at bits 2w..2w+1), zeros before the sequence start."""
    w = model_len - 1
    s = seq.to(torch.int64)
    n = s.shape[-1]
    padded = torch.cat([s.new_zeros(s.shape[:-1] + (w,)), s], dim=-1)
    ctx = torch.zeros_like(s)
    for k in range(w):
        ctx |= padded[..., k:k + n] << (2 * k)
    return ctx


def read_variants(reads, lengths):
    """(reversed, complemented) copies of padded reads, zeros past each
    read's length."""
    b, l = reads.shape
    r = reads.to(torch.int64)
    i = torch.arange(l, device=reads.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    ridx = lens - 1 - i
    rev = torch.where(ridx >= 0, torch.gather(r, 1, ridx.clamp(min=0)), 0)
    comp = torch.where(i < lens, 3 - r, 0)
    return rev, comp


def revcomp(reads, lengths):
    l = reads.shape[1]
    i = torch.arange(l, device=reads.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    rc = torch.gather(3 - reads.to(torch.int64), 1, (lens - 1 - i) % l)
    return torch.where(i < lens, rc, 0)


def walk(mip_flat, tab, ctx, thresh, depth, visit=None):
    """Final node of each walk (``tab`` the flat offset of its (model,
    frame) table); ``visit(nodes)`` sees the nodes whose mut_info_pos
    each level reads."""
    node = torch.zeros_like(ctx)
    done = torch.zeros(ctx.shape, dtype=torch.bool, device=ctx.device)
    for _ in range(depth):
        if visit is not None:
            visit(node)
        pos = mip_flat[tab + node]
        avail = pos >= thresh
        b = (ctx >> (2 * pos.clamp(min=0))) & 3
        node = torch.where(done | ~avail, node, 4 * node + b + 1)
        done = done | ~avail
    if visit is not None:
        visit(node)
    pos = mip_flat[tab + node]
    return torch.where(pos == -2, torch.div(node - 1, 4,
                                            rounding_mode="floor"), node)


class Bank:
    """Every ICM of the bank as flat tables on ``device``."""

    def __init__(self, paths, device):
        icms = [read_icm(p) for p in paths]
        self.model_len = icms[0].model_len
        self.depth = max(m.model_depth for m in icms)
        self.p = icms[0].periodicity
        self.n = max(m.mip.shape[1] for m in icms)
        mip = np.full((len(icms), self.p, self.n), -1, np.int64)
        probs = np.zeros((len(icms), self.p, self.n, 4), np.float64)
        for k, m in enumerate(icms):
            mip[k, :, :m.mip.shape[1]] = m.mip
            probs[k, :, :m.mip.shape[1]] = m.probs
        self.m = len(icms)
        self.mip = torch.from_numpy(mip.reshape(-1)).to(device)
        self.probs = torch.from_numpy(probs.reshape(-1)).to(device)

    def score(self, seq):
        """(M,) float64 total log-prob of one read (int tensor of bases,
        on the bank's device) under each ICM, frame cycling."""
        n = seq.shape[0]
        s = seq.to(torch.int64)
        i = torch.arange(n, device=s.device)
        ctx = pack_contexts(s, self.model_len)[None, :]
        thresh = (self.model_len - 1 - i).clamp(min=0)[None, :]
        models = torch.arange(self.m, device=s.device)[:, None]
        tab = (models * self.p + (i % self.p)[None, :]) * self.n
        node = walk(self.mip, tab, ctx.expand(self.m, n), thresh, self.depth)
        return self.probs[(tab + node) * 4 + s[None, :]].sum(dim=1)

    def classify(self, seq):
        """(M,) float64 larger of the two strands' scores of one read."""
        s = seq.to(torch.int64)
        rc = torch.flip(3 - s, dims=[0])
        return torch.maximum(self.score(s), self.score(rc))
