"""ICM walks on the GPU: wrappers of the CUDA kernels in ``csrc/``.

  * ``mg_six_frame`` runs ``csrc/six_frame.cu``, the counterpart of
    ``glimmer_mg_tpu.ops.icm_pallas.mg_six_frame_pallas`` (per-read
    prediction); its twin is ``ops.icm_score.mg_six_frame_batch``. The
    kernel reads prob tables with the pruned back-up folded in
    (``fold_pruned_probs``, made once per bank by the caller).
  * ``bank_score_reads_kernel`` runs ``csrc/bank_walk.cu`` on one strand,
    the counterpart of ``icm_pallas.bank_score_reads_pallas`` (Phymm
    classification), over the 16-bit tables of ``pack_tables`` or, with
    ``int8=True``, the 8-bit tables of ``pack_tables_int8``; its twin is
    ``ops.icm_score.bank_score_reads_packed``.
    ``bank_score_both_strands`` runs the same kernel on a read batch and
    its reverse complements in one launch and returns the per-(read,
    model) max, the scores of ``classify_step_pallas``. Both check the
    bases and lengths they are given (one host sync), except inside
    ``values_in_range``, whose callers made them in range by construction.

CUDA tensors go to the kernel (or the wrapper raises); CPU tensors go to
the plain PyTorch twin, which the kernel matches bitwise. There is no
fallback from one to the other.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from ..utils import observe
from . import icm_score

LANES = 128
# fixed-point scale of the packed bank tables: 16-bit signed, range
# [-128, 0], quantization step 1/512 after round-to-nearest
FIXED_SCALE = 256.0
# deepest bank walk: its (model, frame) table must fit a block's shared
# memory (csrc/bank_walk.cu)
MAX_BANK_DEPTH = 7
# deepest six-frame gene walk (a template argument of csrc/six_frame.cu,
# whose levels all sit in a block's shared memory)
MAX_SIX_FRAME_DEPTH = 7

# Kernel launches (plain counts; reset by callers): mg_six_frame's, and
# the bank walk's over 16-bit and over 8-bit tables (either entry point).
launches = 0
bank_walk_launches = 0
bank_walk_int8_launches = 0


# the bank walk's value check, skipped on this thread inside values_in_range
_vouched = threading.local()


def reset_launches() -> None:
    global launches, bank_walk_launches, bank_walk_int8_launches
    launches = 0
    bank_walk_launches = 0
    bank_walk_int8_launches = 0


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


def pack_tables_int8(bank_mip: np.ndarray, bank_probs: np.ndarray,
                     depth: int = 7, scale: float = 8.0):
    """8-bit variant of :func:`pack_tables`: FOUR int8 fixed-point
    log-probs per int32 (one node's 4 bases in one lane entry), halving
    the prob-table rows (342 -> 171); numpy, the same tables as
    ``glimmer_mg_tpu.ops.icm_pallas.pack_tables_int8``.

    Range [-128/scale, 0] with quantization step 1/scale (round-to-
    nearest error <= 1/(2*scale) = 1/16 per base at the default).
    Returns (level_mip (M, P, LR, 128) int32, probs_pk (M, P, rows, 128)
    int32, scale).
    """
    m, p, n = bank_mip.shape
    rows = (n + LANES - 1) // LANES
    pad_n = rows * LANES

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

    probs_eff = np.array(bank_probs, dtype=np.float32)
    parent = np.maximum(0, (np.arange(n) - 1) // 4)
    mi, pi, ni = np.nonzero(bank_mip == -2)
    probs_eff[mi, pi, ni] = probs_eff[mi, pi, parent[ni]]

    probs_pad = np.zeros((m, p, pad_n, 4), dtype=np.float32)
    probs_pad[:, :, :n] = probs_eff
    probs_t = probs_pad.reshape(m, p, rows, LANES, 4).transpose(0, 1, 2, 4, 3)
    probs_t = np.maximum(probs_t, np.float32(-128.0 / scale))
    q = np.clip(np.rint(probs_t * scale), -128, 0).astype(np.int64) & 0xFF
    packed = (
        q[:, :, :, 0] | (q[:, :, :, 1] << 8) | (q[:, :, :, 2] << 16)
        | (q[:, :, :, 3] << 24)
    ).astype(np.uint32).astype(np.int32)
    return level_mip, packed.reshape(m, p, rows, LANES), scale


def _check(name, t, dtypes, ndim, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_table_sizes(gene_mip, indep_mip, depth):
    """Table sizes the kernel trusts: a walk of ``depth`` levels stays in a
    table of (4^(depth+1)-1)/3 nodes (the null ICM has depth 2). Shapes
    only: no host sync."""
    if gene_mip.shape[2] < (4 ** (depth + 1) - 1) // 3:
        raise ValueError(f"gene tables of {gene_mip.shape[2]} nodes are too "
                         f"small for depth {depth}")
    if indep_mip.shape[2] < 21:
        raise ValueError("null tables need the 21 nodes of depth 2")


def _check_ranges(gene_mip, indep_mip, reads, lengths, group, depth,
                  values=True):
    """Index ranges the kernel trusts: the table sizes and, with
    ``values``, group rows in [0, G) and lengths in [0, L] (one reduction
    and one host sync)."""
    _check_table_sizes(gene_mip, indep_mip, depth)
    if not values:
        return
    bad = ((group < 0) | (group >= gene_mip.shape[0]) | (lengths < 0)
           | (lengths > reads.shape[1]))
    if bool(bad.any()):
        raise ValueError("group must lie in [0, G) and lengths in [0, L]")


def check_tables(gene_mip: np.ndarray, indep_mip: np.ndarray, depth: int):
    """The six-frame tables' ranges, on the host before their upload (once
    per bank): the table sizes for ``depth`` and every mip value in
    [-2, 15]. Raises ValueError."""
    _check_table_sizes(gene_mip, indep_mip, depth)
    for name, mip in (("gene", gene_mip), ("null", indep_mip)):
        if mip.size and (mip.min() < -2 or mip.max() > 15):
            raise ValueError(f"{name} mip values must lie in [-2, 15]")


def check_reads(reads: np.ndarray, lengths: np.ndarray, group: np.ndarray,
                n_groups: int):
    """A padded read batch's ranges, on the host before its upload: bases
    in [0, 3], lengths in [0, L], groups in [0, ``n_groups``). Raises
    ValueError."""
    if reads.size and (reads.min() < 0 or reads.max() > 3):
        raise ValueError("bases must lie in [0, 3]")
    if lengths.size and (lengths.min() < 0
                         or lengths.max() > reads.shape[1]):
        raise ValueError("lengths must lie in [0, L]")
    if group.size and (group.min() < 0 or group.max() >= n_groups):
        raise ValueError("group must lie in [0, G)")


def fold_pruned_probs(mip: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Prob tables with the pruned back-up folded in, on the tables' device:
    a node whose mip is -2 carries its parent's four values (one step, as
    the twin's back-up after a walk; node 0 keeps its own, as in the JAX
    package's ``pack_tables_exact``). mip (..., N), probs (..., N, 4)."""
    n = mip.shape[-1]
    parent = ((torch.arange(n, device=mip.device) - 1) // 4).clamp(min=0)
    return torch.where((mip == -2)[..., None], probs[..., parent, :], probs)


def mg_six_frame(gene_mip, gene_probs, indep_mip, indep_probs, reads, lengths,
                 group, model_len: int = 12, depth: int = 7,
                 gene_periodicity: int = 3, folded=None,
                 ranges_checked: bool = False):
    """Six-frame per-position gene/null log-probs of padded reads.

    Same arguments and return convention as
    :func:`glimmer_mg_torch.ops.icm_score.mg_six_frame_batch`:
    (gene (B, 6, L) f32, indep (B, 6, L) f32), rows 0..2 over the reversed
    read and 3..5 over the complemented read. Bases lie in [0, 3] and mip
    values in [-2, 15] (as every trained ICM's).

    ``folded`` = (gene probs, null probs) from :func:`fold_pruned_probs`
    of the same tables, made once per bank; without it the CUDA route folds
    for this call. The CPU route ignores it (the twin backs up itself).

    ``ranges_checked=True`` says that the caller checked the index values
    on the host before the upload (``check_reads`` for each batch,
    ``check_tables`` once per bank, as the prediction engine does): the
    call then checks shapes, types and table sizes only, and makes no host
    sync. Without it the group and length values are checked on the
    tensors (one host sync on the card).
    """
    device = reads.device
    if device.type == "cpu":
        _check_ranges(gene_mip, indep_mip, reads, lengths, group, depth,
                      values=not ranges_checked)
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
    if not 0 <= depth <= MAX_SIX_FRAME_DEPTH:
        raise ValueError(f"depth must be in [0, {MAX_SIX_FRAME_DEPTH}]")
    if gene_mip.data_ptr() % 16:
        raise ValueError("gene_mip must be 16-byte aligned")
    if folded is not None:
        gene_f, indep_f = folded
        _check("folded gene probs", gene_f, (torch.float32,), 4, device)
        _check("folded null probs", indep_f, (torch.float32,), 4, device)
        if (gene_f.shape != gene_probs.shape
                or indep_f.shape != indep_probs.shape):
            raise ValueError("folded tables must match gene_probs and "
                             "indep_probs")
    _check_ranges(gene_mip, indep_mip, reads, lengths, group, depth,
                  values=not ranges_checked)
    if folded is None:
        gene_f = fold_pruned_probs(gene_mip, gene_probs)
        indep_f = fold_pruned_probs(indep_mip, indep_probs)
    return _launch_six_frame(gene_mip, gene_f, indep_mip, indep_f, reads,
                             lengths, group, model_len, depth)


def _launch_six_frame(gene_mip, gene_probs_f, indep_mip, indep_probs_f,
                      reads, lengths, group, model_len, depth):
    """Launch ``csrc/six_frame.cu`` on arguments that :func:`mg_six_frame`
    has checked, with folded prob tables, and count the launch. Returns
    (gene, indep) (B, 6, L) f32."""
    from .. import _build

    device = reads.device
    _g, p, n = gene_mip.shape
    b, l = reads.shape
    n2 = indep_mip.shape[2]
    gene = torch.empty((b, 6, l), dtype=torch.float32, device=device)
    ind = torch.empty((b, 6, l), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _build.lib().gmt_six_frame(
        reads.data_ptr(), lengths.data_ptr(), group.data_ptr(),
        gene_mip.data_ptr(), gene_probs_f.data_ptr(), indep_mip.data_ptr(),
        indep_probs_f.data_ptr(), gene.data_ptr(), ind.data_ptr(), b, l, p,
        n, n2, model_len, depth, gene_mip.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"six_frame kernel launch failed (cudaError {err})")
    global launches
    launches += 1
    return gene, ind


@contextlib.contextmanager
def values_in_range():
    """A scope, on this thread, whose bank-walk calls take every base in
    [0, 3] and every length in [0, L] as given: their callers made them so
    by construction (``parallel.phymm.PhymmBank``'s codes all come from
    ``dna.SUBSCRIPT_TABLE``). Inside it ``_check_bank_walk`` checks shapes
    only and makes no host sync; counter ``k2_checked_by_construction``,
    a call. Leaving the scope, by an exception too, restores the check."""
    outer = getattr(_vouched, "on", False)
    _vouched.on = True
    try:
        yield
    finally:
        _vouched.on = outer


def _check_bank_walk(level_mip, probs_pk, reads, lengths, model_len, depth,
                     int8):
    """Shapes and index ranges the bank-walk kernel trusts: a walk of
    ``depth`` (<= 7, the deepest whose tables fit a block's shared memory)
    levels reads only the level rows and prob rows the tables hold,
    lengths lie in [0, L], bases in [0, 3], the context fits 30 bits and
    an int32 sum of int16 values cannot overflow. Span ``k2.check``. One
    host sync for the value checks (counter ``k2_host_syncs``), none
    inside ``values_in_range``."""
    with observe.span("k2.check"):
        _check_bank_shapes(level_mip, probs_pk, reads, lengths, model_len,
                           depth, int8)
        if getattr(_vouched, "on", False):
            observe.count("k2_checked_by_construction")
            return
        bad = bool(((lengths < 0) | (lengths > reads.shape[1])).any()
                   | ((reads < 0) | (reads > 3)).any())
    observe.count("k2_host_syncs")
    if bad:
        raise ValueError("lengths must lie in [0, L] and bases in [0, 3]")


def _check_bank_shapes(level_mip, probs_pk, reads, lengths, model_len, depth,
                       int8):
    """``_check_bank_walk``'s checks of shapes and sizes: no host sync."""
    if level_mip.dim() != 4 or probs_pk.dim() != 4:
        raise ValueError("level_mip and probs_pk must be 4-D")
    m, p, lr, lanes = level_mip.shape
    if p != 3 or lanes != LANES:
        raise ValueError(f"level_mip must be (M, 3, LR, {LANES}), got "
                         f"{tuple(level_mip.shape)}")
    if (probs_pk.shape[0] != m or probs_pk.shape[1] != 3
            or probs_pk.shape[3] != LANES):
        raise ValueError("probs_pk must be (M, 3, R, 128) matching level_mip")
    if reads.dim() != 2 or lengths.shape != (reads.shape[0],):
        raise ValueError("reads must be (B, L) and lengths (B,)")
    if reads.shape[1] % 3 != 0:
        raise ValueError("pad read length to a multiple of 3")
    if reads.shape[1] >= 65536:
        raise ValueError("reads must be shorter than 65,536 bases")
    if model_len < 1 or model_len - 1 > 15:
        raise ValueError("model_len must be in [1, 16] (30-bit context)")
    if depth < 0 or depth > MAX_BANK_DEPTH:
        raise ValueError(f"depth must be in [0, {MAX_BANK_DEPTH}]")
    if sum(_level_rows(depth)) > lr:
        raise ValueError(f"level_mip has {lr} rows, too few for depth {depth}")
    nodes = (4 ** (depth + 1) - 1) // 3
    need = (1 if int8 else 2) * ((nodes + LANES - 1) // LANES)
    if probs_pk.shape[2] < need:
        raise ValueError(f"probs_pk has {probs_pk.shape[2]} rows, too few "
                         f"for depth {depth}")


def _bank_walk(level_mip, probs_pk, reads, lengths, model_len, depth, int8,
               scale, strands):
    """Check the arguments and launch ``csrc/bank_walk.cu`` on CUDA
    tensors; (B, M) f32."""
    device = reads.device
    _check("level_mip", level_mip, (torch.int32,), 4, device)
    _check("probs_pk", probs_pk, (torch.int32,), 4, device)
    _check("reads", reads, (torch.int32,), 2, device)
    _check("lengths", lengths, (torch.int32,), 1, device)
    _check_bank_walk(level_mip, probs_pk, reads, lengths, model_len, depth,
                     int8)
    m, _p, lr, _lanes = level_mip.shape
    b, l = reads.shape
    if 3 * m > 65535:
        raise ValueError("at most 21,845 models per call (grid y)")
    if level_mip.data_ptr() % 16 or probs_pk.data_ptr() % 16:
        raise ValueError("tables must be 16-byte aligned")

    from .. import _build

    with observe.span("k2.launch"):
        fields = torch.empty((strands, 3, b, l // 3), dtype=torch.int32,
                             device=device)
        partial = torch.empty((strands, 3, b, m), dtype=torch.int32,
                              device=device)
        out = torch.empty((b, m), dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _build.lib().gmt_bank_walk(
            level_mip.data_ptr(), probs_pk.data_ptr(), reads.data_ptr(),
            lengths.data_ptr(), fields.data_ptr(), partial.data_ptr(),
            out.data_ptr(), b, l, m, lr, probs_pk.shape[2], model_len,
            depth, strands, int(int8), 1.0 / scale, stream)
    if err != 0:
        raise RuntimeError(f"bank_walk kernel launch failed (cudaError {err})")
    global bank_walk_launches, bank_walk_int8_launches
    if int8:
        bank_walk_int8_launches += 1
    else:
        bank_walk_launches += 1
    return out


def _bank_route(name, reads):
    if reads.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {reads.device}")
    return reads.device.type == "cuda"


def bank_score_reads_kernel(level_mip, probs_pk, reads, lengths,
                            model_len: int = 12, depth: int = 7,
                            int8: bool = False, scale: float = FIXED_SCALE):
    """(B, M) f32 total log-prob of each read under each bank ICM, frame 0
    at base 0, cycling, over the 16-bit tables of :func:`pack_tables` or,
    with ``int8``, the 8-bit tables of :func:`pack_tables_int8` (pass the
    ``scale`` it returns).

    One strand per call, like ``bank_score_reads_pallas``. level_mip
    (M, 3, LR, 128) int32, probs_pk (M, 3, R, 128) int32, reads (B, L)
    int32 with L % 3 == 0, lengths (B,) int32.
    """
    if _bank_route("bank_score_reads_kernel", reads):
        return _bank_walk(level_mip, probs_pk, reads, lengths, model_len,
                          depth, int8, scale, 1)
    _check_bank_walk(level_mip, probs_pk, reads, lengths, model_len, depth,
                     int8)
    return icm_score.bank_score_reads_packed(
        level_mip, probs_pk, reads, lengths, model_len, depth, int8=int8,
        scale=scale)


def bank_score_both_strands(level_mip, probs_pk, reads, lengths,
                            model_len: int = 12, depth: int = 7,
                            int8: bool = False, scale: float = FIXED_SCALE):
    """(B, M) f32 max of :func:`bank_score_reads_kernel` over the reads and
    their reverse complements (``icm_score.revcomp_reads``): one launch on
    CUDA tensors, the twin on both strands on CPU tensors."""
    if _bank_route("bank_score_both_strands", reads):
        return _bank_walk(level_mip, probs_pk, reads, lengths, model_len,
                          depth, int8, scale, 2)
    _check_bank_walk(level_mip, probs_pk, reads, lengths, model_len, depth,
                     int8)
    rc = icm_score.revcomp_reads(reads, lengths)
    return torch.maximum(
        *(icm_score.bank_score_reads_packed(
            level_mip, probs_pk, r, lengths, model_len, depth, int8=int8,
            scale=scale) for r in (reads, rc)))
