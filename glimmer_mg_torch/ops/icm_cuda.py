"""ICM walks on the GPU: wrappers of the CUDA kernels in ``csrc/``.

  * ``mg_six_frame`` runs ``csrc/six_frame.cu``, the counterpart of
    ``glimmer_mg_tpu.ops.icm_pallas.mg_six_frame_pallas`` (per-read
    prediction); its twin is ``ops.icm_score.mg_six_frame_batch``.
  * ``bank_score_reads_kernel`` runs ``csrc/bank_walk.cu``, the counterpart
    of ``icm_pallas.bank_score_reads_pallas`` (Phymm classification), over
    the tables of ``pack_tables``; its twin is
    ``ops.icm_score.bank_score_reads_packed``.

CUDA tensors go to the kernel (or the wrapper raises); CPU tensors go to
the plain PyTorch twin, which the kernel matches bitwise. There is no
fallback from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from . import icm_score

LANES = 128
# fixed-point scale of the packed bank tables: 16-bit signed, range
# [-128, 0], quantization step 1/512 after round-to-nearest
FIXED_SCALE = 256.0

# Kernel launches (plain counts; reset by callers): mg_six_frame's and
# bank_score_reads_kernel's.
launches = 0
bank_walk_launches = 0


def reset_launches() -> None:
    global launches, bank_walk_launches
    launches = 0
    bank_walk_launches = 0


def _level_rows(depth: int) -> list[int]:
    """Rows of 128 lanes needed for each walk level 0..depth-1."""
    return [max(1, (4**k + LANES - 1) // LANES) for k in range(depth)]


def pack_tables(bank_mip: np.ndarray, bank_probs: np.ndarray, depth: int = 7):
    """(M, P, N) mip + (M, P, N, 4) probs -> bank-walk kernel tables (numpy;
    the same tables as ``glimmer_mg_tpu.ops.icm_pallas.pack_tables``).

    Returns (level_mip (M, P, LR, 128) int32, probs_pk (M, P, rows*2, 128)
    int32) where LR = sum of per-level row counts and probs_pk packs two
    16-bit fixed-point log-probs per int32 (scale FIXED_SCALE, clamped to
    [-128, 0]): probs_pk[:, :, hi*2 + (base>>1), lo] holds base 2(base>>1)
    in bits 15..0 and base 2(base>>1)+1 in bits 31..16 for
    node = hi*128 + lo. Pruned nodes carry their parent's probs.
    """
    m, p, n = bank_mip.shape
    rows = (n + LANES - 1) // LANES
    pad_n = rows * LANES

    # per-level mut_info_pos tables (walk reads levels 0..depth-1 only)
    lr = _level_rows(depth)
    level_mip = np.full((m, p, sum(lr), LANES), -1, dtype=np.int32)
    off = 0
    for k, rk in enumerate(lr):
        base = (4**k - 1) // 3
        cnt = min(4**k, max(0, n - base))
        flat = np.full((m, p, rk * LANES), -1, dtype=np.int32)
        flat[:, :, :cnt] = bank_mip[:, :, base : base + cnt].astype(np.int32)
        level_mip[:, :, off : off + rk] = flat.reshape(m, p, rk, LANES)
        off += rk

    # fold pruned backup: probs[pruned] = probs[parent]
    probs_eff = np.array(bank_probs, dtype=np.float32)
    parent = np.maximum(0, (np.arange(n) - 1) // 4)
    pruned = bank_mip == -2  # (M, P, N)
    mi, pi, ni = np.nonzero(pruned)
    probs_eff[mi, pi, ni] = probs_eff[mi, pi, parent[ni]]

    probs_pad = np.zeros((m, p, pad_n, 4), dtype=np.float32)
    probs_pad[:, :, :n] = probs_eff
    # [m, p, hi, lo, base] -> [m, p, hi*2 + base>>1, lo] with two int16
    # fixed-point values per int32 (even base low half, odd base high half).
    probs_t = probs_pad.reshape(m, p, rows, LANES, 4).transpose(0, 1, 2, 4, 3)
    # clamp BEFORE scaling: device-trained banks mark zero-prob entries with
    # -FLT_MAX, which overflows f32 when multiplied by FIXED_SCALE
    probs_t = np.maximum(probs_t, np.float32(-32768.0 / FIXED_SCALE))
    q = np.clip(np.rint(probs_t * FIXED_SCALE), -32768, 0).astype(np.int64)
    even = q[:, :, :, 0::2]  # bases 0, 2 -> pairs 0, 1
    odd = q[:, :, :, 1::2]
    packed = ((odd << 16) | (even & 0xFFFF)).astype(np.int32)
    # [m, p, rows, 2 pairs, lanes] -> [m, p, rows*2, lanes]
    packed = packed.reshape(m, p, rows * 2, LANES)
    return level_mip, packed


def _check(name, t, dtypes, ndim, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_ranges(gene_mip, indep_mip, reads, lengths, group, depth):
    """Index ranges the kernel trusts: a walk of ``depth`` levels stays in
    a table of (4^(depth+1)-1)/3 nodes (the null ICM has depth 2), group
    rows lie in [0, G), lengths in [0, L]. One reduction and one host sync
    for the value checks."""
    if gene_mip.shape[2] < (4 ** (depth + 1) - 1) // 3:
        raise ValueError(f"gene tables of {gene_mip.shape[2]} nodes are too "
                         f"small for depth {depth}")
    if indep_mip.shape[2] < 21:
        raise ValueError("null tables need the 21 nodes of depth 2")
    bad = ((group < 0) | (group >= gene_mip.shape[0]) | (lengths < 0)
           | (lengths > reads.shape[1]))
    if bool(bad.any()):
        raise ValueError("group must lie in [0, G) and lengths in [0, L]")


def mg_six_frame(gene_mip, gene_probs, indep_mip, indep_probs, reads, lengths,
                 group, model_len: int = 12, depth: int = 7,
                 gene_periodicity: int = 3):
    """Six-frame per-position gene/null log-probs of padded reads.

    Same arguments and return convention as
    :func:`glimmer_mg_torch.ops.icm_score.mg_six_frame_batch`:
    (gene (B, 6, L) f32, indep (B, 6, L) f32), rows 0..2 over the reversed
    read and 3..5 over the complemented read.
    """
    device = reads.device
    if device.type == "cpu":
        _check_ranges(gene_mip, indep_mip, reads, lengths, group, depth)
        return icm_score.mg_six_frame_batch(
            gene_mip, gene_probs, indep_mip, indep_probs, reads, lengths,
            group, model_len=model_len, depth=depth,
            gene_periodicity=gene_periodicity)
    if device.type != "cuda":
        raise ValueError(f"mg_six_frame: unsupported device {device}")

    mip_types = (torch.int16, torch.int32)
    _check("gene_mip", gene_mip, mip_types, 3, device)
    _check("gene_probs", gene_probs, (torch.float32,), 4, device)
    _check("indep_mip", indep_mip, (gene_mip.dtype,), 3, device)
    _check("indep_probs", indep_probs, (torch.float32,), 4, device)
    _check("reads", reads, (torch.int32,), 2, device)
    _check("lengths", lengths, (torch.int32,), 1, device)
    _check("group", group, (torch.int32,), 1, device)
    g, p, n = gene_mip.shape
    b, l = reads.shape
    n2 = indep_mip.shape[2]
    if tuple(gene_probs.shape) != (g, p, n, 4):
        raise ValueError("gene_probs must be (G, P, N, 4) matching gene_mip")
    if (indep_mip.shape[:2] != (g, 3)
            or tuple(indep_probs.shape) != (g, 3, n2, 4)):
        raise ValueError("indep tables must be (G, 3, N2[, 4])")
    if lengths.shape[0] != b or group.shape[0] != b:
        raise ValueError("lengths/group must have one entry per read")
    if model_len - 1 > 16 or model_len < 3:
        raise ValueError("model_len must be in [3, 17] (32-bit context)")
    if p != gene_periodicity:
        raise ValueError("gene_periodicity must equal the table's frame count")
    _check_ranges(gene_mip, indep_mip, reads, lengths, group, depth)

    from .. import _build

    gene = torch.empty((b, 6, l), dtype=torch.float32, device=device)
    ind = torch.empty((b, 6, l), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _build.lib().gmt_six_frame(
        reads.data_ptr(), lengths.data_ptr(), group.data_ptr(),
        gene_mip.data_ptr(), gene_probs.data_ptr(), indep_mip.data_ptr(),
        indep_probs.data_ptr(), gene.data_ptr(), ind.data_ptr(),
        b, l, p, n, n2, model_len, depth, gene_mip.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"six_frame kernel launch failed (cudaError {err})")
    global launches
    launches += 1
    return gene, ind


def _check_bank_walk(level_mip, probs_pk, reads, lengths, model_len, depth):
    """Shapes and index ranges the bank-walk kernel trusts: a walk of
    ``depth`` levels reads only the level rows and prob rows the tables
    hold, lengths lie in [0, L], the context fits 30 bits and an int32 sum
    of int16 values cannot overflow. One host sync for the lengths."""
    if level_mip.dim() != 4 or probs_pk.dim() != 4:
        raise ValueError("level_mip and probs_pk must be 4-D")
    m, p, lr, lanes = level_mip.shape
    if p != 3 or lanes != LANES:
        raise ValueError(f"level_mip must be (M, 3, LR, {LANES}), got "
                         f"{tuple(level_mip.shape)}")
    if (probs_pk.shape[0] != m or probs_pk.shape[1] != 3
            or probs_pk.shape[3] != LANES):
        raise ValueError("probs_pk must be (M, 3, R2, 128) matching level_mip")
    if reads.dim() != 2 or lengths.shape != (reads.shape[0],):
        raise ValueError("reads must be (B, L) and lengths (B,)")
    if reads.shape[1] % 3 != 0:
        raise ValueError("pad read length to a multiple of 3")
    if reads.shape[1] >= 65536:
        raise ValueError("reads must be shorter than 65,536 bases")
    if model_len < 1 or model_len - 1 > 15:
        raise ValueError("model_len must be in [1, 16] (30-bit context)")
    if depth < 0 or sum(_level_rows(depth)) > lr:
        raise ValueError(f"level_mip has {lr} rows, too few for depth {depth}")
    nodes = (4 ** (depth + 1) - 1) // 3
    if probs_pk.shape[2] < 2 * ((nodes + LANES - 1) // LANES):
        raise ValueError(f"probs_pk has {probs_pk.shape[2]} rows, too few "
                         f"for depth {depth}")
    if bool(((lengths < 0) | (lengths > reads.shape[1])).any()):
        raise ValueError("lengths must lie in [0, L]")


def bank_score_reads_kernel(level_mip, probs_pk, reads, lengths,
                            model_len: int = 12, depth: int = 7):
    """(B, M) f32 total log-prob of each read under each bank ICM, frame 0
    at base 0, cycling, over the 16-bit tables of :func:`pack_tables`.

    One strand per call, like ``bank_score_reads_pallas``. level_mip
    (M, 3, LR, 128) int32, probs_pk (M, 3, R2, 128) int32, reads (B, L)
    int32 with L % 3 == 0, lengths (B,) int32.
    """
    device = reads.device
    if device.type == "cpu":
        _check_bank_walk(level_mip, probs_pk, reads, lengths, model_len,
                         depth)
        return icm_score.bank_score_reads_packed(
            level_mip, probs_pk, reads, lengths, model_len, depth)
    if device.type != "cuda":
        raise ValueError(f"bank_score_reads_kernel: unsupported device "
                         f"{device}")

    _check("level_mip", level_mip, (torch.int32,), 4, device)
    _check("probs_pk", probs_pk, (torch.int32,), 4, device)
    _check("reads", reads, (torch.int32,), 2, device)
    _check("lengths", lengths, (torch.int32,), 1, device)
    _check_bank_walk(level_mip, probs_pk, reads, lengths, model_len, depth)
    m, _p, lr, _lanes = level_mip.shape
    b, l = reads.shape
    if m > 65535:
        raise ValueError("at most 65,535 models per call (grid y)")

    from .. import _build

    out = torch.empty((b, m), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _build.lib().gmt_bank_walk(
        level_mip.data_ptr(), probs_pk.data_ptr(), reads.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, l, m, lr, probs_pk.shape[2],
        model_len, depth, stream)
    if err != 0:
        raise RuntimeError(f"bank_walk kernel launch failed (cudaError {err})")
    global bank_walk_launches
    bank_walk_launches += 1
    return out
