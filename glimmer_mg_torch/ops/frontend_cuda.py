"""The frontend on the GPU: the wrapper of KF.

``frontend`` runs ``csrc/frontend.cu``, the counterpart of the JAX
package's frontend (``glimmer_mg_tpu.ops.device_predict``'s
``_read_tables`` through ``_assemble_events`` as ``_frontend_one`` runs
them, XLA inside its jitted device program): ORF slots, start scoring and
event assembly of a chunk in one launch, with no host sync, in the
error-free and in the substitution mode (``consts["subs"]``, with or
without per-base qualities). Its plain version, which the kernel matches
bit for bit on every output, is ``ops.frontend.frontend``.

The rule: CPU tensors go to the plain version; CUDA tensors launch KF in
either mode. There is no fallback from the kernel to the plain version: a
failed build or launch raises.
"""

from __future__ import annotations

import torch

from . import frontend as plain
from .event_dp_cuda import _check

# Kernel launches (a plain count; reset by callers).
launches = 0

# Longest padded read the kernel takes: 8 Lp + 33 candidates must index as
# int32 and the blocked prefix sum has at most 8 levels.
MAX_LP = 1 << 26

# A read's workspace that outgrows the shared memory it may take (the
# kernel's smem_room: half an SM's, so that two reads share one; on an H100
# error-free f64 from Lp 1,662, f32 from Lp 2,526; substitution mode f64
# from Lp 1,242, f32 from Lp 1,503) goes to a global scratch buffer
# instead: grid = the blocks an SM holds on that route (blocks_per_sm: 4
# error-free, 3 in substitution mode) x SMs, each block looping over
# reads. Both choices are measured at Lp 2,304 in PERF.md section 6.
_ROOM: dict = {}
_OCC: dict = {}
_SMS: dict = {}

_TABLES = (
    ("fwd_start", torch.bool, 65), ("rev_start", torch.bool, 65),
    ("fwd_stop", torch.bool, 65), ("rev_stop", torch.bool, 65),
    ("which_fwd", torch.int32, 65), ("which_rev", torch.int32, 65),
)


def reset_launches() -> None:
    global launches
    launches = 0


def workspace_bytes(Lp: int, f64: bool, subs: bool = False) -> int:
    """Bytes of one read's working arrays in the kernel at Lp."""
    from .. import _build
    return int(_build.lib().gmt_frontend_ws(Lp, int(f64), int(subs)))


def narrow_lp() -> int:
    """Lp below which the kernel keeps its position scans, ids and class
    cumsums as int16_t and its sort keys in 32 bits."""
    from .. import _build
    return int(_build.lib().gmt_frontend_narrow_lp())


def blocks_per_sm(Lp: int, f64: bool, rbs: bool, subs: bool = False) -> int:
    """Blocks (reads) of the instantiation an SM of the current device holds
    at Lp (cudaOccupancyMaxActiveBlocksPerMultiprocessor, the workspace in
    shared memory when it takes that route, else on the global-scratch
    route)."""
    key = (torch.cuda.current_device(), Lp, f64, rbs, subs)
    if key not in _OCC:
        from .. import _build
        nb = _build.lib().gmt_frontend_occupancy(int(f64), int(rbs),
                                                 int(subs), Lp)
        if nb < 0:
            raise RuntimeError(f"frontend kernel occupancy (cudaError "
                               f"{-nb})")
        _OCC[key] = nb
    return _OCC[key]


def _smem_room(device, f64: bool, rbs: bool, subs: bool = False) -> int:
    key = (device.index, f64, rbs, subs)
    if key not in _ROOM:
        from .. import _build
        room = _build.lib().gmt_frontend_smem_room(int(f64), int(rbs),
                                                   int(subs))
        if room < 0:
            raise RuntimeError(f"frontend kernel attributes (cudaError "
                               f"{-room})")
        _ROOM[key] = room
    return _ROOM[key]


def _sms(device) -> int:
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device.index]


def frontend(seq, n, gi, gene6, ind6, bank, Lp: int, consts, max_events,
             quals=None):
    """``ops.frontend.frontend``'s function and signature: (ev, n_events),
    ev the (B, E) event rows pos, typ, sub, id (int32), score (the carry's
    float type) and trunc (bool), in substitution mode also err_pos and
    err_typ (int32), n_events (B,) int32 the count of valid candidates
    (also past E = min(max_events, 4 Lp + 18), in substitution mode
    min(max_events, 8 Lp + 33)). ``quals`` (B, Lp) uint8 or None is read
    only in substitution mode.

    On CUDA tensors: one launch of KF, which reads the bank's tables by
    group (group indices are clamped in the kernel, so nothing is checked
    on the values and nothing syncs); inputs are checked for device,
    dtype, shape and contiguity first. On CPU tensors the plain version
    runs."""
    device = seq.device
    if device.type == "cpu":
        return plain.frontend(seq, n, gi, gene6, ind6, bank, Lp, consts,
                              max_events, quals=quals)
    if device.type != "cuda":
        raise ValueError(f"frontend: unsupported device {device}")

    fdt = consts["fdt"]
    if fdt not in (torch.float64, torch.float32):
        raise TypeError(f"fdt must be float64 or float32, got {fdt}")
    B = seq.shape[0] if seq.dim() == 2 else -1
    i32 = (torch.int32,)
    _check("seq", seq, i32, (B, Lp), device)
    _check("n", n, i32, (B,), device)
    _check("gi", gi, i32, (B,), device)
    _check("gene6", gene6, (torch.float32,), (B, 6, Lp), device)
    _check("ind6", ind6, (torch.float32,), (B, 6, Lp), device)
    subs = bool(consts.get("subs"))
    if Lp % 3 or Lp < 6 or Lp >= MAX_LP:
        raise ValueError(f"Lp must be a multiple of 3 in [6, {MAX_LP}), "
                         f"got {Lp}")
    if not subs:
        quals = None
    elif quals is not None:
        _check("quals", quals, (torch.uint8,), (B, Lp), device)
    G = bank["prior"].shape[0]
    for name, dt, w in _TABLES:
        _check(name, bank[name], (dt,), (G, w), device)
    _check("prior", bank["prior"], (torch.float32,), (G,), device)
    NS = bank["start_lo"].shape[-1]
    _check("start_lo", bank["start_lo"], (torch.float32,), (G, NS), device)
    LN = bank["len_score"].shape[-1]
    _check("len_score", bank["len_score"], (torch.float64,), (G, 3, LN),
           device)
    _check("ignore_score_len", bank["ignore_score_len"], i32, (G,), device)
    C, WT = bank["pwm_cols"].shape[1:3]
    _check("pwm_cols", bank["pwm_cols"], (torch.float64,), (G, C, WT, 4),
           device)
    _check("pwm_n", bank["pwm_n"], i32, (G,), device)
    _check("pwm_user", bank["pwm_user"], (torch.float64,), (G, WT, 4),
           device)
    _check("pwm_is_user", bank["pwm_is_user"], (torch.bool,), (G,), device)
    _check("gc_lp", bank["gc_lp"], (torch.float64,), (G, 4), device)
    W = int(consts["W"])
    if G < 1 or NS < 3 or LN < 1 or C < 1:
        raise ValueError("the bank needs a group, 3 start-codon log-odds, a "
                         "length score and a PWM class row")
    if not 0 <= W <= WT:
        raise ValueError(f"W must lie in [0, {WT}], got {W}")
    if max_events < 1:
        raise ValueError("max_events must be at least 1")

    E = min(int(max_events), (8 * Lp + 33) if subs else (4 * Lp + 18))

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    ev = {"pos": empty((B, E), torch.int32), "typ": empty((B, E), torch.int32),
          "sub": empty((B, E), torch.int32), "id": empty((B, E), torch.int32),
          "score": empty((B, E), fdt), "trunc": empty((B, E), torch.bool)}
    if subs:
        ev["err_pos"] = empty((B, E), torch.int32)
        ev["err_typ"] = empty((B, E), torch.int32)
    n_events = empty((B,), torch.int32)
    if B == 0:
        return ev, n_events

    from .. import _build

    f64 = fdt == torch.float64
    ws = workspace_bytes(Lp, f64, subs)
    scratch = None
    grid = B
    if ws > _smem_room(device, f64, W > 0, subs):
        grid = min(B, blocks_per_sm(Lp, f64, W > 0, subs) * _sms(device))
        scratch = empty((grid * ws,), torch.uint8)
    cp = plain.cp_table(device) if quals is not None else None
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _build.lib().gmt_frontend(
        seq.data_ptr(), n.data_ptr(), gi.data_ptr(), gene6.data_ptr(),
        ind6.data_ptr(),
        *(bank[name].data_ptr() for name, _dt, _w in _TABLES),
        *(bank[k].data_ptr() for k in (
            "prior", "start_lo", "len_score", "ignore_score_len", "pwm_cols",
            "pwm_n", "pwm_user", "pwm_is_user", "gc_lp")),
        *(ev[k].data_ptr() for k in ("pos", "typ", "sub", "id", "score",
                                     "trunc")),
        n_events.data_ptr(),
        None if scratch is None else scratch.data_ptr(), ws, grid, B, Lp, G,
        NS, LN, C, WT, W, int(consts["ws"]), int(consts["min_gene_len"]), E,
        int(f64), float(consts["event_threshold"]),
        float(consts["start_threshold"]), int(subs),
        None if quals is None else quals.data_ptr(),
        None if cp is None else cp.data_ptr(),
        *(ev[k].data_ptr() if subs else None for k in ("err_pos", "err_typ")),
        *plain.stop_penalty_values(), stream)
    if err != 0:
        raise RuntimeError(f"frontend kernel launch failed (cudaError {err})")
    global launches
    launches += 1
    return ev, n_events
