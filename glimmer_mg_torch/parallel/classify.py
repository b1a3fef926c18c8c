"""Read classification steps: every read against every bank ICM, both strands.

Counterpart of ``glimmer_mg_tpu.parallel.classify`` without its mesh and
EM steps: a dense (reads x models) score matrix, forward and
reverse-complement, per-read max (the Phymm scripts' fwd/rev max,
reference scripts/scoreReadsGlim.pl:450-482), then the argmax.

  * ``classify_step``: the exact f32 walk (``ops.icm_score``);
  * ``classify_step_kernel``: the 16-bit fixed-point bank walk,
    ``ops.icm_cuda.bank_score_reads_kernel`` (the CUDA kernel on CUDA
    tensors, its twin on CPU tensors), the counterpart of
    ``classify_step_pallas``.

``torch.argmax`` returns the first maximal index, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from glimmer_mg_tpu.models import dna

from ..ops import icm_cuda, icm_score


def revcomp_reads(reads, lengths):
    """Reverse complement of padded reads (the pad stays at the tail)."""
    l = reads.shape[1]
    i = torch.arange(l, device=reads.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    comp = 3 - reads  # a<->t, c<->g in index space
    rc = torch.gather(comp, 1, (lens - 1 - i) % l)
    return torch.where(i < lens, rc, 0)


def _both_strands(score, reads, lengths):
    """Per-read max of ``score(reads)`` over the forward reads and their
    reverse complements, and its argmax."""
    scores = torch.maximum(score(reads), score(revcomp_reads(reads, lengths)))
    return scores, torch.argmax(scores, dim=1).to(torch.int32)


def classify_step(bank_mip, bank_probs, reads, lengths, model_len=12,
                  depth=7):
    """Score reads fwd + revcomp against the bank with the exact walk.
    Returns (scores (B, M) f32, best (B,) int32)."""
    return _both_strands(
        lambda r: icm_score.bank_score_reads(bank_mip, bank_probs, r,
                                             lengths, model_len, depth),
        reads, lengths)


def classify_step_kernel(level_mip, probs_pk, reads, lengths, model_len=12,
                         depth=7):
    """``classify_step`` through the bank-walk kernel over
    ``icm_cuda.pack_tables`` output; one launch per strand."""
    return _both_strands(
        lambda r: icm_cuda.bank_score_reads_kernel(level_mip, probs_pk, r,
                                                   lengths, model_len, depth),
        reads, lengths)


def pad_reads(seqs, length=None):
    """Encode + pad a list of sequences to a (B, L) int32 batch (numpy)."""
    enc = [dna.encode(s) for s in seqs]
    lengths = np.array([len(e) for e in enc], dtype=np.int32)
    if length is None:
        length = int(max((len(e) for e in enc), default=0))
    reads = np.zeros((len(enc), length), dtype=np.int32)
    for i, e in enumerate(enc):
        reads[i, : len(e)] = e[:length]
    return reads, lengths
