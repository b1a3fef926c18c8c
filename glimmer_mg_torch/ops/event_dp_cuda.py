"""The event-graph DP and traceback on the GPU: the wrapper of K3.

``event_dp_traceback`` runs ``csrc/event_dp.cu``, the counterpart of
``glimmer_mg_tpu.ops.device_predict``'s ``_event_dp_batched`` and
``_traceback_batched`` (XLA inside the JAX package's jitted device
program), on CUDA tensors: one launch a chunk, no host sync. Its plain
version, which the kernel matches bit for bit, is
``ops.event_dp.event_dp_traceback``; CPU tensors go there. There is no
fallback from one to the other.
"""

from __future__ import annotations

import functools
import math

import torch

from . import event_dp
from .device_predict import MAX_GENES

# Most events a read the kernel takes: a read's rows and state sit in
# shared memory (csrc/event_dp.cu).
MAX_E = 1024

# Kernel launches (a plain count; reset by callers).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _check(name, t, dtypes, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=64)
def _layout(B, E, sdt):
    """Per dtype of K3's outputs (score type, int32, bool): the buffer's
    length and, per output, (its index, shape, strides, offset), each
    output starting 16-byte aligned."""
    i32, b8 = torch.int32, torch.bool
    shapes = ((B, E), (B, E), (B, 6), (B,), *[(B, MAX_GENES)] * 6,
              (B, MAX_GENES), (B, MAX_GENES), (B,))
    dtypes = (sdt, i32, i32, b8, i32, i32, i32, i32, b8, sdt, i32, i32, i32)
    layout = []
    for dt in (sdt, i32, b8):
        step, n, views = 16 // dt.itemsize, 0, []
        for k, (shape, d) in enumerate(zip(shapes, dtypes)):
            if d == dt:
                views.append((k, shape, (shape[-1], 1)[-len(shape):], n))
                n += -(-math.prod(shape) // step) * step
        layout.append((dt, n, tuple(views)))
    return tuple(layout)


def outputs(B, E, sdt, device):
    """K3's 13 outputs, uninitialised, as the twin gives them (score, bp,
    best, wovf, g_id, g_stop, g_len, g_sign, g_trunc, g_score, g_epos,
    g_etyp, cnt): contiguous views of one buffer a dtype, each starting
    16-byte aligned."""
    out = [None] * 13
    for dt, n, views in _layout(B, E, sdt):
        buf = torch.empty(n, dtype=dt, device=device)
        for k, shape, strides, offset in views:
            out[k] = buf.as_strided(shape, strides, offset)
    return tuple(out)


def event_dp_traceback(ev, tables, groups, consts, ne):
    """Process_Events then Trace_Back over (B, E) event rows.

    ``ev`` holds the frontend's rows (pos, typ, sub, id int32, score f64
    or f32, trunc bool, and in substitution mode err_pos/err_typ int32),
    ``tables`` the bank's adjacency tables (``adj_or`` (G, 4) f32,
    ``adj_dist`` (G, 3, D) f32, ``adj_dist_len`` (G, 3) int32, as in
    ``bank_to_device``'s dict), ``groups`` (B,) int32 each read's bank row
    and ``ne`` (B,) int32 the real event counts. Returns what
    ``event_dp.event_dp_traceback`` returns on ``event_dp._prefetch_adj``
    of the tables: (score, bp, best, wovf, g_id, g_stop, g_len, g_sign,
    g_trunc, g_score, g_epos, g_etyp, cnt). On CUDA tensors one launch of
    K3, which reads the tables by group; index values (groups included)
    are clamped in the kernel, so nothing is checked on the values and
    nothing syncs.
    """
    device = ev["pos"].device
    if device.type == "cpu":
        return event_dp.event_dp_traceback(
            ev, event_dp._prefetch_adj(tables, groups), consts, ne)
    if device.type != "cuda":
        raise ValueError(f"event_dp_traceback: unsupported device {device}")

    B, E = ev["pos"].shape
    sdt = ev["score"].dtype
    if sdt not in (torch.float64, torch.float32):
        raise TypeError(f"score has dtype {sdt}, expected float64 or float32")
    i32 = (torch.int32,)
    for name in ("pos", "typ", "sub", "id"):
        _check(name, ev[name], i32, (B, E), device)
    _check("score", ev["score"], (sdt,), (B, E), device)
    _check("trunc", ev["trunc"], (torch.bool,), (B, E), device)
    has_err = ev.get("err_pos") is not None
    if has_err:
        _check("err_pos", ev["err_pos"], i32, (B, E), device)
        _check("err_typ", ev["err_typ"], i32, (B, E), device)
    _check("ne", ne, i32, (B,), device)
    _check("groups", groups, i32, (B,), device)
    ao, dl, tab = (tables[k] for k in ("adj_or", "adj_dist_len", "adj_dist"))
    G, D = ao.shape[0], tab.shape[-1]
    _check("adj_or", ao, (torch.float32,), (G, 4), device)
    _check("adj_dist_len", dl, i32, (G, 3), device)
    _check("adj_dist", tab, (torch.float32,), (G, 3, D), device)
    if E > MAX_E:
        raise ValueError(f"at most {MAX_E} events a read, got {E}")
    if G < 1 or D < 1:
        raise ValueError("the adjacency tables must hold a group and a value")

    out = outputs(B, E, sdt, device)
    if B == 0:
        return out

    from .. import _build

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(device).cuda_stream
    err = _build.lib().gmt_event_dp(
        *(ptr(ev.get(k)) for k in ("pos", "typ", "sub", "id", "score",
                                    "trunc", "err_pos", "err_typ")),
        ne.data_ptr(), groups.data_ptr(), ao.data_ptr(), dl.data_ptr(),
        tab.data_ptr(), *(t.data_ptr() for t in out), B, E, D, G,
        int(consts["max_olap"]), int(sdt == torch.float64), int(has_err),
        stream)
    if err != 0:
        raise RuntimeError(f"event_dp kernel launch failed (cudaError {err})")
    global launches
    launches += 1
    return out
