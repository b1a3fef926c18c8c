"""Read classification and EM clustering steps, on one rank or sharded.

Counterpart of ``glimmer_mg_tpu.parallel.classify``: a dense (reads x
models) score matrix, forward and reverse-complement, per-read max (the
Phymm scripts' fwd/rev max, reference scripts/scoreReadsGlim.pl:450-482),
then the argmax.

  * ``classify_step``: the exact f32 walk (``ops.icm_score``);
  * ``classify_step_kernel``: the 16-bit fixed-point bank walk over both
    strands, ``ops.icm_cuda.bank_score_both_strands`` (one launch of the
    CUDA kernel on CUDA tensors, its twin on CPU tensors), the
    counterpart of ``classify_step_pallas``;
  * ``classify_step_kernel_sharded``: the same walk over a (data, model)
    mesh of ranks (``parallel.mesh``), each rank on its (read shard x
    model shard) block, the counterpart of ``classify_step_pallas_sharded``;
  * ``em_step``: one Scimm EM step (SURVEY P12): classify with the exact
    walk, hard-assign, retrain the whole bank with
    ``ops.icm_train_device.train_icm_bank``; with a mesh, on the rank's
    shards, the counts summed over the data group.

``torch.argmax`` and ``np.argmax`` return the first maximal index, as
``jnp.argmax`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import dna
from ..ops import icm_cuda, icm_score, icm_train_device
from ..ops.icm_score import revcomp_reads
from . import mesh as pmesh


def _with_best(scores):
    return scores, torch.argmax(scores, dim=1).to(torch.int32)


def classify_step(bank_mip, bank_probs, reads, lengths, model_len=12,
                  depth=7):
    """Score reads fwd + revcomp against the bank with the exact walk.
    Returns (scores (B, M) f32, best (B,) int32)."""
    fwd, rev = (icm_score.bank_score_reads(bank_mip, bank_probs, r, lengths,
                                           model_len, depth)
                for r in (reads, revcomp_reads(reads, lengths)))
    return _with_best(torch.maximum(fwd, rev))


def classify_step_kernel(level_mip, probs_pk, reads, lengths, model_len=12,
                         depth=7):
    """``classify_step`` through the bank-walk kernel over
    ``icm_cuda.pack_tables`` output; both strands in one launch."""
    return _with_best(icm_cuda.bank_score_both_strands(
        level_mip, probs_pk, reads, lengths, model_len, depth))


def classify_step_kernel_sharded(mesh, level_mip, probs_pk, reads, lengths,
                                 model_len=12, depth=7):
    """``classify_step_kernel`` over a (data, model) mesh of ranks.

    Each rank runs the bank walk on its local block: ``level_mip`` and
    ``probs_pk`` are its slice of the packed tables along ``model``
    (``mesh.shard_bank``), ``reads`` and ``lengths`` its slice of the
    batch along ``data`` (``mesh.shard_reads``): the reference's two
    phymm_par.py fan-out modes at once (ICM-sharded :146-200, read-sharded
    :210-261), with one all-gather over the world as the file merge
    (``mesh.materialize``). Returns (scores (B, M) f32, best (B,) int32)
    numpy, the whole matrix on every rank in global order, so the argmax
    breaks ties as the one-rank run does. ``parallel.phymm.classify_file``
    walks a rank's whole share of a file before its one gather.
    """
    block = icm_cuda.bank_score_both_strands(level_mip, probs_pk, reads,
                                             lengths, model_len, depth)
    scores = pmesh.materialize(mesh, block)
    return scores, np.argmax(scores, axis=1).astype(np.int32)


def em_step(bank_mip, bank_probs, reads, lengths, n_models: int,
            model_len: int = 12, depth: int = 7, periodicity: int = 3,
            mesh=None):
    """One full Scimm-style EM training step on the reads' device.

    classify -> hard assignment -> retrain the whole bank from windowed
    context counts (chi-square deleted interpolation) -> return the new
    bank plus the assignment: (new_mip, new_probs, best, scores).

    With ``mesh`` the arguments are this rank's shards: the bank's slice
    along ``model`` (padded to the axis with ``mesh.pad_models``), the
    reads' along ``data``. The scores are gathered (``best`` and
    ``scores`` cover the whole batch and the first ``n_models`` models,
    numpy), each rank assigns its own reads, and the trainer sums the
    counts over the data group, so every rank returns the whole new bank.
    """
    if mesh is None:
        scores, best = classify_step(bank_mip, bank_probs, reads, lengths,
                                     model_len, depth)
        mine = best
    else:
        block, _ = classify_step(bank_mip, bank_probs, reads, lengths,
                                 model_len, depth)
        scores = pmesh.materialize(mesh, block)[:, :n_models]
        best = np.argmax(scores, axis=1).astype(np.int32)
        mine = torch.from_numpy(
            best[pmesh.data_rows(mesh, len(best))]).to(reads.device)
    assign = torch.nn.functional.one_hot(mine.long(), n_models).to(
        torch.float32)
    new_mip, new_probs = icm_train_device.train_icm_bank(
        reads.to(torch.int32), lengths, assign, n_models=n_models,
        model_len=model_len, depth=depth, periodicity=periodicity,
        data_group=None if mesh is None else mesh.get_group("data"))
    return new_mip, new_probs, best, scores


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
