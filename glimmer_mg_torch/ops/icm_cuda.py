"""Six-frame ICM walk on the GPU: wrapper of the CUDA kernel ``csrc/six_frame.cu``.

Counterpart of ``glimmer_mg_tpu.ops.icm_pallas.mg_six_frame_pallas``. CUDA
tensors go to the kernel (or the wrapper raises); CPU tensors go to the
plain PyTorch twin ``ops.icm_score.mg_six_frame_batch``, which the kernel
matches bitwise. There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from . import icm_score

# Kernel launches made by mg_six_frame (a plain count; reset by callers).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


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
