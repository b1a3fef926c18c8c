"""The raw matrix's DATA rows as text on the GPU: the wrapper of
``csrc/raw_text.cu``.

``rows_text(scores)`` gives the ``BEGIN_DATA_MATRIX`` body that
``parallel.phymm.write_raw_phymm_output`` writes for an (n_reads,
n_models) score matrix: one line a model, its column of scores as
``%.4f`` joined by single spaces. On a CUDA tensor the kernel renders it,
byte for byte as ``plain_rows``, the Python loop the writer ran before,
which is the yardstick and the route of a CPU tensor. There is no
fallback from one to the other.
"""

from __future__ import annotations

import torch

# Matrices rendered by the kernel (one a call, its four launches; a plain
# count, reset by callers).
launches = 0

# The pinned host buffer the text is downloaded into, reused and grown.
_host = None


def reset_launches() -> None:
    global launches
    launches = 0


def plain_rows(scores) -> str:
    """The body of the (n, m) numpy matrix ``scores``: for each model g,
    its scores ``%.4f``, joined by spaces, and a newline."""
    return "".join(" ".join("%.4f" % s for s in scores[:, g]) + "\n"
                   for g in range(scores.shape[1]))


def rows_text(scores: torch.Tensor):
    """The body's bytes. A CPU tensor gives ``plain_rows`` of its values,
    encoded. A CUDA tensor must be a contiguous (n, m) float32 matrix:
    the kernel renders the text on the card, and the host waits twice: for
    the text's length, then for its download into a pinned buffer. The
    memoryview returned is that buffer, valid until the next call."""
    if scores.device.type == "cpu":
        return plain_rows(scores.numpy()).encode("ascii")
    if scores.device.type != "cuda":
        raise ValueError(f"rows_text: unsupported device {scores.device}")
    if scores.dtype != torch.float32:
        raise TypeError(f"scores has dtype {scores.dtype}, expected float32")
    if scores.dim() != 2:
        raise ValueError(f"scores must be (n, m), got {tuple(scores.shape)}")
    if not scores.is_contiguous():
        raise ValueError("scores must be contiguous")
    stream = torch.cuda.current_stream(scores.device)
    text = _render(scores, stream.cuda_stream)
    host = _pinned(text.numel())
    host.copy_(text, non_blocking=True)
    stream.synchronize()
    return memoryview(host.numpy())


def _render(scores, stream):
    """The kernels' text of a checked (n, m) float32 matrix, a uint8
    tensor on its device; ``stream`` is the CUDA stream's handle."""
    global launches
    from .. import _build

    n, m = scores.shape
    if n == 0 or m == 0:  # nothing to render: m empty lines
        return torch.full((m,), ord("\n"), dtype=torch.uint8,
                          device=scores.device)
    lib = _build.lib()
    # a row's offsets are int32 in the kernel; the grid's y holds the
    # models in blocks of 32
    if n * lib.gmt_raw_text_max_slot() >= 2 ** 31 or m > 32 * 65535:
        raise ValueError(f"a {n} x {m} matrix is too large for the kernel")
    tiles = -(-n // lib.gmt_raw_text_tile_reads())
    tile_len = torch.empty(m * tiles, dtype=torch.int32, device=scores.device)
    row_off = torch.empty(m + 1, dtype=torch.int64, device=scores.device)
    _raise(lib.gmt_raw_text_measure(scores.data_ptr(), n, m,
                                    tile_len.data_ptr(), row_off.data_ptr(),
                                    stream))
    text = torch.empty(int(row_off[m]), dtype=torch.uint8,
                       device=scores.device)
    _raise(lib.gmt_raw_text_write(scores.data_ptr(), n, m,
                                  tile_len.data_ptr(), row_off.data_ptr(),
                                  text.data_ptr(), stream))
    launches += 1
    return text


def _raise(err):
    if err != 0:
        raise RuntimeError(f"raw_text kernel launch failed (cudaError {err})")


def _pinned(nbytes):
    """The first ``nbytes`` of the pinned buffer, grown by a quarter more
    than asked when too small."""
    global _host
    if _host is None or _host.numel() < nbytes:
        _host = torch.empty(nbytes + nbytes // 4, dtype=torch.uint8,
                            pin_memory=True)
    return _host[:nbytes]
