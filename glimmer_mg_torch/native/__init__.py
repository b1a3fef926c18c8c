"""ctypes bindings for the native per-read prediction engine (engine.cpp).

The native engine is the production runtime for the per-read host path:
ORF enumeration, start/indel/substitution scanning, RBS + feature scoring,
the event-graph DP and traceback — exactly mirroring the Python oracle in
``glimmer_mg_torch.engine`` (which remains the parity reference, tested
byte-for-byte against the reference binaries).  The 6-frame ICM LLR
precompute is either passed in per read (device-computed) or computed
natively by the same tree walk.

Build: automatic at first use (g++ -O3) into ``build/_engine.so`` at the
repository root, one process at a time; a failed build raises
RuntimeError with the compiler's output.
"""

from __future__ import annotations

import ctypes as ct
import fcntl
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "engine.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build")
_SO = os.path.join(_BUILD_DIR, "_engine.so")
_ABI_VERSION = 7

_lib = None
_lib_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def _stale() -> bool:
    return (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC))


def _build(force: bool = False) -> None:
    """Compile engine.cpp into build/ when stale (or ``force``). Processes
    take turns on a lock file and the library is renamed into place, so
    concurrent callers never load a half-written file. Raises RuntimeError
    with g++'s output on failure."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(_SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (force or _stale()):
            return  # another process built it while this one waited
        tmp = f"{_SO}.{os.getpid()}.tmp"
        cmd = [
            "g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
            "-o", tmp, _SRC,
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, _SO)


def get_lib():
    """Load (building if needed) the native engine. Raises
    NativeUnavailable when disabled (GLIMMER_MG_TPU_NATIVE=0) and
    RuntimeError when the build fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if os.environ.get("GLIMMER_MG_TPU_NATIVE") == "0":
            raise NativeUnavailable("disabled via GLIMMER_MG_TPU_NATIVE=0")
        if _stale():
            _build()
        lib = ct.CDLL(_SO)
        lib.gmg_abi_version.restype = ct.c_int32
        if lib.gmg_abi_version() != _ABI_VERSION:
            _build(force=True)
            lib = ct.CDLL(_SO)
            if lib.gmg_abi_version() != _ABI_VERSION:
                raise RuntimeError("native engine ABI mismatch after rebuild")
        lib.gmg_predict_batch.restype = ct.c_int64
        lib.gmg_predict_batch.argtypes = [
            ct.c_void_p, ct.c_int32, ct.c_int32, ct.c_int32,
            ct.c_void_p, ct.c_int64,
            ct.c_void_p, ct.c_void_p, ct.c_int64, ct.c_void_p,
            ct.c_void_p, ct.c_int32,
        ]
        lib.gmg_g3_full.restype = ct.c_int64
        lib.gmg_g3_full.argtypes = [
            ct.c_void_p, ct.c_void_p, ct.c_int64, ct.c_void_p, ct.c_int64,
        ]
        lib.gmg_g3_predict.restype = ct.c_int64
        lib.gmg_g3_predict.argtypes = [
            ct.c_void_p, ct.c_void_p, ct.c_int64,
            ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int32,
            ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
            ct.c_void_p, ct.c_void_p, ct.c_void_p,
            ct.c_void_p, ct.c_int64,
        ]
        lib.gmg_fixed_frame_probs.restype = None
        lib.gmg_fixed_frame_probs.argtypes = [
            ct.c_void_p, ct.c_void_p, ct.c_int32, ct.c_void_p, ct.c_void_p,
        ]
        lib.gmg_frame_scores.restype = None
        lib.gmg_frame_scores.argtypes = [
            ct.c_void_p, ct.c_void_p, ct.c_int32, ct.c_void_p,
        ]
        lib.gmg_length_trunc_scan.restype = None
        lib.gmg_length_trunc_scan.argtypes = [
            ct.c_void_p, ct.c_void_p, ct.c_int32, ct.c_int32,
            ct.c_double, ct.c_double, ct.c_void_p, ct.c_void_p,
        ]
        lib.gmg_log_add_acc.restype = None
        lib.gmg_log_add_acc.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    try:
        get_lib()
        return True
    except NativeUnavailable:
        return False


# -- ctypes mirrors of the C structs (keep in sync with engine.cpp) ---------


class CIcm(ct.Structure):
    _fields_ = [
        ("model_len", ct.c_int32), ("depth", ct.c_int32),
        ("periodicity", ct.c_int32), ("num_nodes", ct.c_int32),
        ("mip", ct.c_void_p), ("probs", ct.c_void_p),
    ]


class CModels(ct.Structure):
    _fields_ = [
        ("gene", CIcm), ("indep", CIcm),
        ("n_fwd_start", ct.c_int32), ("n_rev_start", ct.c_int32),
        ("n_fwd_stop", ct.c_int32), ("n_rev_stop", ct.c_int32),
        ("fwd_start", ct.c_void_p), ("rev_start", ct.c_void_p),
        ("fwd_stop", ct.c_void_p), ("rev_stop", ct.c_void_p),
        ("logodds_prior", ct.c_float),
        ("n_start_logodds", ct.c_int32), ("start_logodds", ct.c_void_p),
        ("ld_n_dists", ct.c_int32), ("ld_table_len", ct.c_int32),
        ("ld_min_aa_len", ct.c_int32),
        ("ld_full", ct.c_void_p), ("ld_trunc", ct.c_void_p),
        ("ld_trunc2", ct.c_void_p), ("ld_frag_lengths", ct.c_void_p),
        ("ld_full_trunc_merge", ct.c_void_p),
        ("adj_ff", ct.c_float), ("adj_fr", ct.c_float),
        ("adj_rf", ct.c_float), ("adj_rr", ct.c_float),
        ("ad_max_overlap", ct.c_int32),
        ("ad_ff_len", ct.c_int32), ("ad_fr_len", ct.c_int32),
        ("ad_rf_len", ct.c_int32),
        ("ad_ff", ct.c_void_p), ("ad_fr", ct.c_void_p), ("ad_rf", ct.c_void_p),
        ("pwm_width", ct.c_int32), ("user_rbs", ct.c_int32),
        ("pwm_cols", ct.c_void_p),
        ("n_meta_pwms", ct.c_int32), ("meta_width", ct.c_int32),
        ("meta_cols", ct.c_void_p),
        ("meta_gc_log", ct.c_double), ("meta_at_log", ct.c_double),
        ("ribosome_window_size", ct.c_int32),
        ("min_gene_len", ct.c_int32), ("max_olap_bases", ct.c_int32),
        ("event_threshold", ct.c_double), ("start_threshold", ct.c_double),
        ("ignore_score_len", ct.c_int64),
        ("allow_truncated_orfs", ct.c_int32),
        ("use_first_start_codon", ct.c_int32),
        ("circular", ct.c_int32),
    ]


class CReadJob(ct.Structure):
    _fields_ = [
        ("seq", ct.c_void_p), ("len", ct.c_int32),
        ("quals", ct.c_void_p), ("have_qual", ct.c_int32),
        ("frame_scores", ct.c_void_p), ("models", ct.c_void_p),
    ]


# numpy view of a CReadJob array (matches the ctypes struct layout)
_JOB_DT = np.dtype(
    {
        "names": ["seq", "len", "quals", "have_qual", "frame_scores",
                  "models"],
        "formats": [np.uint64, np.int32, np.uint64, np.int32, np.uint64,
                    np.uint64],
        "offsets": [0, 8, 16, 24, 32, 40],
        "itemsize": 48,
    }
)


_CT2NP = {ct.c_int32: np.int32, ct.c_int64: np.int64, ct.c_double: np.float64}


def _struct_dtype(cls) -> np.dtype:
    """numpy dtype matching a ctypes Structure's exact layout."""
    names = [n for n, _ in cls._fields_]
    return np.dtype(
        {
            "names": names,
            "formats": [_CT2NP[t] for _, t in cls._fields_],
            "offsets": [getattr(cls, n).offset for n in names],
            "itemsize": ct.sizeof(cls),
        }
    )


def _models_addr(nm) -> int:
    """Cached address of a NativeModels' C struct."""
    a = getattr(nm, "_addr", None)
    if a is None:
        a = ct.addressof(nm.c)
        nm._addr = a
    return a


class CGeneOut(ct.Structure):
    _fields_ = [
        ("read_idx", ct.c_int32), ("id", ct.c_int32),
        ("start", ct.c_int64), ("stop", ct.c_int64),
        ("frame", ct.c_int32), ("score", ct.c_double),
        ("truncated", ct.c_int32), ("n_errors", ct.c_int32),
        ("err_offset", ct.c_int64),
    ]


def _ptr(arr: np.ndarray) -> int:
    return arr.ctypes.data


class NativeModels:
    """Marshaled per-Models native model bundle (arrays kept alive here)."""

    def __init__(self, models):
        import math

        self._keep = []  # keep numpy arrays alive

        def hold(arr, dtype):
            a = np.ascontiguousarray(arr, dtype=dtype)
            self._keep.append(a)
            return a

        c = CModels()

        def fill_icm(dst, icm):
            # one int16 of tail padding: the engine's AVX-512 walk gathers
            # 32-bit words at 16-bit entries, so the last entry's load reads
            # 2 bytes past the table
            mip2 = np.ascontiguousarray(icm.mip, dtype=np.int16)
            mip = hold(np.concatenate([mip2.reshape(-1),
                                       np.array([-1], dtype=np.int16)]),
                       np.int16)
            probs = hold(icm.probs, np.float32)
            dst.model_len = icm.model_len
            dst.depth = icm.model_depth
            dst.periodicity = icm.periodicity
            dst.num_nodes = mip2.shape[1]
            dst.mip = _ptr(mip)
            dst.probs = _ptr(probs)

        fill_icm(c.gene, models.gene_icm)
        fill_icm(c.indep, models.indep_model)

        pat = models.patterns
        for name in ("fwd_start", "rev_start", "fwd_stop", "rev_stop"):
            a = hold(getattr(pat, name), np.int32)
            setattr(c, "n_" + name, len(a))
            setattr(c, name, _ptr(a))

        c.logodds_prior = float(models.logodds_prior)

        slo = hold(models.logodds_start.log_odds, np.float32)
        c.n_start_logodds = len(slo)
        c.start_logodds = _ptr(slo)

        ld = models.logodds_length
        n_dists = len(ld.full)
        table_len = len(ld.full[0])
        c.ld_n_dists = n_dists
        c.ld_table_len = table_len
        c.ld_min_aa_len = int(ld.min_aa_len)
        c.ld_full = _ptr(hold(np.stack(ld.full), np.float64))
        c.ld_trunc = _ptr(hold(np.stack(ld.trunc), np.float64))
        c.ld_trunc2 = _ptr(hold(np.stack(ld.trunc2), np.float64))
        c.ld_frag_lengths = _ptr(hold(np.asarray(ld.fragment_lengths), np.float64))
        c.ld_full_trunc_merge = _ptr(
            hold(np.asarray(ld.full_trunc_merge[:n_dists]), np.int32)
        )

        ao = models.logodds_adj_or
        c.adj_ff, c.adj_fr = float(ao.ff), float(ao.fr)
        c.adj_rf, c.adj_rr = float(ao.rf), float(ao.rr)

        ad = models.logodds_adj_dist
        c.ad_max_overlap = int(ad.max_overlap)
        for key in ("ff", "fr", "rf"):
            a = hold(getattr(ad, key), np.float32)
            setattr(c, "ad_" + key + "_len", len(a))
            setattr(c, "ad_" + key, _ptr(a))

        pwm = models.logodds_pwm
        c.user_rbs = 1 if models.user_rbs else 0
        c.pwm_width = pwm.width
        pc = hold(pwm.cols if pwm.width else np.zeros((0, 4)), np.float64)
        c.pwm_cols = _ptr(pc)

        meta = getattr(models, "_meta_pwms", None)
        if meta:
            width = meta[0].width
            if any(p.width != width for p in meta):
                raise NativeUnavailable("mixed meta PWM widths")
            mc = hold(np.stack([p.cols for p in meta]), np.float64)
            c.n_meta_pwms = len(meta)
            c.meta_width = width
            c.meta_cols = _ptr(mc)
            # Reproduce MetaPwmScorer.__init__'s float32 products exactly:
            # gc may be np.float32, so 0.5*gc rounds to f32 before the log.
            gc = models.indep_gc_frac
            c.meta_gc_log = math.log(0.5 * gc)
            c.meta_at_log = math.log(0.5 * (1.0 - gc))
        else:
            c.n_meta_pwms = 0
            c.meta_width = 0
            c.meta_cols = None
            c.meta_gc_log = 0.0
            c.meta_at_log = 0.0

        c.ribosome_window_size = int(models.ribosome_window_size)
        c.min_gene_len = int(models.min_gene_len)
        c.max_olap_bases = int(models.max_olap_bases)
        c.event_threshold = float(models.event_threshold)
        c.start_threshold = float(models.start_threshold)
        c.ignore_score_len = int(models.ignore_score_len)
        c.allow_truncated_orfs = 1 if models.allow_truncated_orfs else 0
        c.use_first_start_codon = (
            1 if getattr(models, "use_first_start_codon", False) else 0
        )
        c.circular = 1 if getattr(models, "circular", False) else 0

        self.c = c


def fixed_frame_probs(gene_icm, indep_icm, seq_idx: np.ndarray):
    """Six fixed-frame per-base log-prob passes via the C++ walk.

    Returns (gene (6, n) f32, ind (6, n) f32): rows 0..2 = frames 0..2 over
    the reversed sequence, rows 3..5 over the complement — the layout
    engine.glimmer3.G3Precompute consumes.  Only the two ICMs are marshaled
    (gmg_fixed_frame_probs reads nothing else from the models struct).
    """
    lib = get_lib()
    keep = []

    def hold(arr, dtype):
        a = np.ascontiguousarray(arr, dtype=dtype)
        keep.append(a)
        return a

    c = CModels()
    for dst, icm in ((c.gene, gene_icm), (c.indep, indep_icm)):
        # tail padding as in NativeModels.fill_icm (AVX-512 gather overread)
        mip2 = np.ascontiguousarray(icm.mip, dtype=np.int16)
        mip = hold(np.concatenate([mip2.reshape(-1),
                                   np.array([-1], dtype=np.int16)]),
                   np.int16)
        probs = hold(icm.probs, np.float32)
        dst.model_len = icm.model_len
        dst.depth = icm.model_depth
        dst.periodicity = icm.periodicity
        dst.num_nodes = mip2.shape[1]
        dst.mip = _ptr(mip)
        dst.probs = _ptr(probs)

    seq = np.ascontiguousarray(seq_idx, dtype=np.int8)
    n = len(seq)
    out_gene = np.empty((6, n), dtype=np.float32)
    out_ind = np.empty((6, n), dtype=np.float32)
    lib.gmg_fixed_frame_probs(
        ct.byref(c), _ptr(seq), n, _ptr(out_gene), _ptr(out_ind)
    )
    return out_gene, out_ind


def _unmarshal_genes(genes_out, rc):
    from ..engine.events import TracedGene

    return [
        TracedGene(
            id=genes_out[g].id, start=genes_out[g].start,
            stop=genes_out[g].stop, frame=genes_out[g].frame,
            score=genes_out[g].score, errors=(),
            truncated=bool(genes_out[g].truncated),
        )
        for g in range(rc)
    ]


def g3_full(models, seq_idx):
    """Complete native glimmer3 per-sequence pipeline (ORF scan, scoring,
    event DP, traceback). Returns list[TracedGene] byte-equal to the
    Python predict_sequence path for linear sequences."""
    lib = get_lib()
    nm = getattr(models, "_native_marshal", None)
    if nm is None:
        nm = NativeModels(models)
        models._native_marshal = nm
    seq = np.ascontiguousarray(seq_idx, dtype=np.int8)
    genes_cap = 64 + len(seq) // 30
    while True:
        genes_out = (CGeneOut * genes_cap)()
        rc = lib.gmg_g3_full(
            ct.byref(nm.c), _ptr(seq), len(seq),
            ct.cast(genes_out, ct.c_void_p), genes_cap,
        )
        if rc >= 0:
            break
        genes_cap *= 4
    return _unmarshal_genes(genes_out, rc)


def g3_predict(models, seq_idx, collected):
    """Native event DP + traceback for one glimmer3 sequence.

    ``collected`` is [(orf, start_list, is_fwd)] in Score_Orfs order, the
    start lists already scored by engine.glimmer3.score_orfs.  Returns
    list[TracedGene] identical to the Python EventEngine path.
    """
    from ..engine.events import TracedGene

    lib = get_lib()
    nm = getattr(models, "_native_marshal", None)
    if nm is None:
        nm = NativeModels(models)
        models._native_marshal = nm
    seq = np.ascontiguousarray(seq_idx, dtype=np.int8)

    n_orfs = len(collected)
    orf_stop = np.empty(n_orfs, dtype=np.int64)
    orf_frame = np.empty(n_orfs, dtype=np.int32)
    orf_olen = np.empty(n_orfs, dtype=np.int64)
    counts = np.empty(n_orfs, dtype=np.int32)
    total = sum(len(sl) for _o, sl, _f in collected)
    st_j = np.empty(total, dtype=np.int64)
    st_pos = np.empty(total, dtype=np.int64)
    st_score = np.empty(total, dtype=np.float64)
    st_first = np.empty(total, dtype=np.uint8)
    st_which = np.empty(total, dtype=np.int32)
    st_trunc = np.empty(total, dtype=np.uint8)
    k = 0
    for i, (orf, sl, is_fwd) in enumerate(collected):
        orf_stop[i] = orf.stop_position
        orf_frame[i] = orf.frame
        orf_olen[i] = orf.orf_len
        counts[i] = len(sl)
        for s in sl:
            st_j[k] = s.j
            st_pos[k] = s.pos
            st_score[k] = s.score
            st_first[k] = 1 if s.first else 0
            st_which[k] = s.which
            st_trunc[k] = 1 if s.truncated else 0
            k += 1

    genes_cap = 64 + len(seq) // 30
    while True:
        genes_out = (CGeneOut * genes_cap)()
        rc = lib.gmg_g3_predict(
            ct.byref(nm.c), _ptr(seq), len(seq),
            _ptr(orf_stop), _ptr(orf_frame), _ptr(orf_olen), n_orfs,
            _ptr(counts), _ptr(st_j), _ptr(st_pos), _ptr(st_score),
            _ptr(st_first), _ptr(st_which), _ptr(st_trunc),
            ct.cast(genes_out, ct.c_void_p), genes_cap,
        )
        if rc >= 0:
            break
        genes_cap *= 4
    return [
        TracedGene(
            id=genes_out[g].id, start=genes_out[g].start,
            stop=genes_out[g].stop, frame=genes_out[g].frame,
            score=genes_out[g].score, errors=(),
            truncated=bool(genes_out[g].truncated),
        )
        for g in range(rc)
    ]


def default_threads() -> int:
    env = os.environ.get("GLIMMER_MG_TPU_THREADS")
    if env:
        return max(1, int(env))
    return max(1, os.cpu_count() or 1)


def predict_batch(jobs, *, allow_indels=False, allow_subs=False,
                  n_threads=None):
    """Run the native engine over ``jobs``.

    jobs: list of (seq_idx int8 array, quals or None, have_qual bool,
    frame_scores (6,n) f64 or None, NativeModels).
    Returns list[list[TracedGene]] matching the Python engine's output.
    """
    from ..engine.events import TracedGene
    from ..engine.mg_host import Error

    lib = get_lib()
    n = len(jobs)
    if n == 0:
        return []
    if n_threads is None:
        n_threads = default_threads()

    keep = []
    cjobs = (CReadJob * n)()
    fast = all(
        j[1] is None and not j[2] and j[3] is None
        and isinstance(j[0], np.ndarray) and j[0].dtype == np.int8
        and j[0].flags.c_contiguous
        for j in jobs
    )
    if fast:
        # vectorized struct fill: per-read ctypes attribute assignment costs
        # ~10 us/read in Python; a numpy view of the job array doesn't
        view = np.frombuffer(cjobs, dtype=_JOB_DT)
        keep = [j[0] for j in jobs]
        view["seq"] = [s.__array_interface__["data"][0] for s in keep]
        lens = np.array([s.shape[0] for s in keep], dtype=np.int64)
        view["len"] = lens
        view["models"] = [_models_addr(j[4]) for j in jobs]
        total_len = int(lens.sum())
    else:
        total_len = 0
        for r, (seq_idx, quals, have_qual, fs, nm) in enumerate(jobs):
            seq = np.ascontiguousarray(seq_idx, dtype=np.int8)
            keep.append(seq)
            cjobs[r].seq = _ptr(seq)
            cjobs[r].len = len(seq)
            total_len += len(seq)
            if quals is not None:
                q = np.ascontiguousarray(quals, dtype=np.int32)
                keep.append(q)
                cjobs[r].quals = _ptr(q)
            else:
                cjobs[r].quals = None
            cjobs[r].have_qual = 1 if have_qual else 0
            if fs is not None:
                f = np.ascontiguousarray(fs, dtype=np.float64)
                if f.shape != (6, len(seq)):
                    raise ValueError("frame_scores shape mismatch")
                keep.append(f)
                cjobs[r].frame_scores = _ptr(f)
            else:
                cjobs[r].frame_scores = None
            cjobs[r].models = ct.cast(ct.byref(nm.c), ct.c_void_p)

    genes_cap = 64 + total_len // 30
    while True:
        err_cap = 2 * genes_cap + 16
        genes_out = (CGeneOut * genes_cap)()
        err_pos = np.empty(err_cap, dtype=np.int64)
        err_type = np.empty(err_cap, dtype=np.int32)
        n_errors = ct.c_int64(0)
        genes_per_read = np.zeros(n, dtype=np.int32)
        rc = lib.gmg_predict_batch(
            ct.cast(cjobs, ct.c_void_p), n,
            1 if allow_indels else 0, 1 if allow_subs else 0,
            ct.cast(genes_out, ct.c_void_p), genes_cap,
            _ptr(err_pos), _ptr(err_type), err_cap, ct.byref(n_errors),
            _ptr(genes_per_read), n_threads,
        )
        if rc >= 0:
            break
        genes_cap *= 4

    results = [[] for _ in range(n)]
    if rc:
        # column-wise unpack (per-gene ctypes attribute reads are ~10x
        # slower than one structured-array view + tolist)
        gv = np.frombuffer(genes_out, dtype=_struct_dtype(CGeneOut), count=rc)
        for ri, gid, st0, sp, fr, sc, tr, ne, eo in zip(
            gv["read_idx"].tolist(), gv["id"].tolist(), gv["start"].tolist(),
            gv["stop"].tolist(), gv["frame"].tolist(), gv["score"].tolist(),
            gv["truncated"].tolist(), gv["n_errors"].tolist(),
            gv["err_offset"].tolist(),
        ):
            errors = (
                tuple(Error(int(err_pos[eo + k]), int(err_type[eo + k]))
                      for k in range(ne))
                if ne else ()
            )
            results[ri].append(
                TracedGene(id=gid, start=st0, stop=sp, frame=fr, score=sc,
                           errors=errors, truncated=bool(tr))
            )
    return results
