"""Build and load the port's CUDA kernels.

At first use, ``csrc/*.cu`` is compiled with ``nvcc`` for Hopper
(``sm_90a``), one process per source started together, and linked into
one shared library with a plain C interface under ``build/`` at the
repository root, which is loaded with ``ctypes``. The library
is rebuilt when any source is newer than it. A failed compile raises.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

PKG_DIR = pathlib.Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build"
LIB_PATH = BUILD_DIR / "libglimmer_mg_torch.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIB = None
build_seconds = None  # wall time of the last compile in this process
# source stem -> ptxas's report (registers, shared memory, spills of each
# kernel) from the last compile in this process
build_log: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(s.stat().st_mtime > built for s in _sources())


def _run(cmds: list[list[str]]) -> list[str]:
    """Run the commands at once; raise with nvcc's output if one fails,
    else return each command's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return outs


def build() -> pathlib.Path:
    """Compile ``csrc/*.cu`` into ``build/`` if the library is missing or
    older than a source: one nvcc per source, all started together, then
    one link. Raises RuntimeError with nvcc's output on failure."""
    global build_seconds
    if not _stale():
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s.stem + ".o") for s in _sources()]
        outs = _run([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", o,
                      str(s)] for o, s in zip(objs, _sources())])
        build_log.update((s.stem, out) for s, out in zip(_sources(), outs))
        so = os.path.join(tmp, LIB_PATH.name)
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]])
        os.replace(so, LIB_PATH)
    build_seconds = time.perf_counter() - t0
    return LIB_PATH


def bind_frontend(cdll: ctypes.CDLL) -> None:
    """Set the ctypes signatures of KF's entry points on ``cdll`` (the
    kernel library, or a library of a frontend source alone, which
    ``chip_smoke.py --kf-ab`` times beside it)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    ll, d = ctypes.c_longlong, ctypes.c_double
    cdll.gmt_frontend.argtypes = ([p] * 28 + [ll] + [i] * 13 + [d, d, i]
                                  + [p] * 4 + [d] * 4 + [p])
    cdll.gmt_frontend.restype = i
    cdll.gmt_frontend_ws.argtypes = [i, i, i]
    cdll.gmt_frontend_ws.restype = ll
    cdll.gmt_frontend_smem_room.argtypes = [i, i, i]
    cdll.gmt_frontend_smem_room.restype = i
    cdll.gmt_frontend_occupancy.argtypes = [i, i, i, i]
    cdll.gmt_frontend_occupancy.restype = i
    cdll.gmt_frontend_narrow_lp.argtypes = []
    cdll.gmt_frontend_narrow_lp.restype = i


def bind_event_dp(cdll: ctypes.CDLL) -> None:
    """Set the ctypes signature of K3's entry point on ``cdll`` (the
    kernel library, or a library of an event-DP source alone, which
    ``chip_smoke.py --k3-ab`` times beside it)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    cdll.gmt_event_dp.argtypes = [p] * 26 + [i] * 7 + [p]
    cdll.gmt_event_dp.restype = i


def bind_raw_text(cdll: ctypes.CDLL) -> None:
    """Set the ctypes signatures of the raw-text kernel's entry points on
    ``cdll`` (the kernel library, or a library of its source alone)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    cdll.gmt_raw_text_measure.argtypes = [p, i, i, p, p, p]
    cdll.gmt_raw_text_measure.restype = i
    cdll.gmt_raw_text_write.argtypes = [p, i, i, p, p, p, p]
    cdll.gmt_raw_text_write.restype = i
    for name in ("gmt_raw_text_tile_reads", "gmt_raw_text_max_slot"):
        getattr(cdll, name).argtypes = []
        getattr(cdll, name).restype = i


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = build()
            cdll = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            cdll.gmt_six_frame.argtypes = [p] * 9 + [i] * 8 + [p]
            cdll.gmt_six_frame.restype = i
            cdll.gmt_six_frame_smem.argtypes = [i] * 2
            cdll.gmt_six_frame_smem.restype = i
            cdll.gmt_bank_walk.argtypes = ([p] * 7 + [i] * 9
                                           + [ctypes.c_float, p])
            cdll.gmt_bank_walk.restype = i
            bind_event_dp(cdll)
            bind_frontend(cdll)
            bind_raw_text(cdll)
            _LIB = cdll
        return _LIB
