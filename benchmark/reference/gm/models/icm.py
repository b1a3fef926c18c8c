# Frozen copy of glimmer_mg_torch/models/icm.py at commit ab5a5d3.
"""Interpolated Context Model (ICM): dense tensor form + binary codec.

The reference (src/ICM/icm.cc, src/ICM/icm.hh) stores, per periodicity frame,
a 4-ary tree of ``(4^(depth+1)-1)/3`` nodes; each node has
``mut_info_pos`` (which of the model_len-1 context positions its children
condition on; -1 = leaf, -2 = pruned) and ``prob[4]`` (log-probability of the
predicted window-final base given the context restrictions on the root path).

Our dense form is two arrays:
  mip   : int16  (periodicity, num_nodes)
  probs : float32(periodicity, num_nodes, 4)

which is directly consumable by the vectorized/Pallas tree-walk kernels and
stacks into an "ICM bank" tensor for Phymm-style classification.

Binary file format parity (reference icm.cc:614-726 Input, 729-803 Output,
961-998 Write_Header): 150-byte text header; 6 little-endian int32 params
{version=200, 150, model_len, depth, periodicity, num_nodes}; then one record
per non-pruned node: int32 node id, 4 float32 probs, int16 mut_info_pos; a
node id of 0 starts the next frame; trailing int32 -1 sentinel. Gaps in node
ids are pruned nodes (mip = -2).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

ICM_VERSION_ID = 200
ID_STRING_LEN = 150
ALPHABET_SIZE = 4
DEFAULT_MODEL_LEN = 12
DEFAULT_MODEL_DEPTH = 7
DEFAULT_PERIODICITY = 3

# Node record: int32 id, 4*f32 prob, int16 mut_info_pos  (22 bytes)
_NODE_STRUCT = np.dtype(
    [("id", "<i4"), ("prob", "<f4", (4,)), ("mip", "<i2")], align=False
)


def num_tree_nodes(depth: int) -> int:
    """(4^(depth+1) - 1) / 3   (reference icm.cc:35)."""
    return (4 ** (depth + 1) - 1) // 3


@dataclasses.dataclass
class ICM:
    """Dense ICM. ``mip[f, n]`` >= 0 is a context position; -1 leaf; -2 pruned."""

    model_len: int
    model_depth: int
    periodicity: int
    mip: np.ndarray  # int16 (periodicity, num_nodes)
    probs: np.ndarray  # float32 (periodicity, num_nodes, 4)

    @property
    def num_nodes(self) -> int:
        return self.mip.shape[1]

    @classmethod
    def empty(
        cls,
        model_len: int = DEFAULT_MODEL_LEN,
        depth: int = DEFAULT_MODEL_DEPTH,
        periodicity: int = DEFAULT_PERIODICITY,
    ) -> "ICM":
        n = num_tree_nodes(depth)
        return cls(
            model_len=model_len,
            model_depth=depth,
            periodicity=periodicity,
            mip=np.zeros((periodicity, n), dtype=np.int16),
            probs=np.zeros((periodicity, n, 4), dtype=np.float32),
        )


_READ_CACHE: dict = {}


def read_icm_cached(path) -> ICM:
    """read_icm with a process-wide cache keyed by (path, mtime_ns, size).

    Model files are the framework's checkpoint store; serving pipelines load
    the same .icm/.gicm files for many reads/chunks, so repeat loads are hot.
    The mtime/size key invalidates on retrain.  Callers must not mutate the
    returned ICM.
    """
    import os

    st = os.stat(path)
    key = (str(path), st.st_mtime_ns, st.st_size)
    hit = _READ_CACHE.get(key)
    if hit is None:
        if len(_READ_CACHE) > 512:
            _READ_CACHE.clear()
        hit = read_icm(path)
        _READ_CACHE[key] = hit
    return hit


def read_icm(path) -> ICM:
    """Load a binary .icm/.gicm file (reference ICM_t::Input, icm.cc:614)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < ID_STRING_LEN + 24:
        raise ValueError(f"{path}: truncated ICM file")
    params = struct.unpack_from("<6i", data, ID_STRING_LEN)
    version, id_len, model_len, depth, periodicity, num_nodes = params
    if version != ICM_VERSION_ID:
        raise ValueError(f"{path}: bad ICM version {version} != {ICM_VERSION_ID}")
    if id_len != ID_STRING_LEN:
        raise ValueError(f"{path}: bad ID_STRING_LEN {id_len}")

    body = data[ID_STRING_LEN + 24 :]
    # Truncate at the -1 sentinel (or EOF) on a whole-record boundary.
    n_rec = len(body) // _NODE_STRUCT.itemsize
    recs = np.frombuffer(body, dtype=_NODE_STRUCT, count=n_rec)
    neg = np.nonzero(recs["id"] < 0)[0]
    if neg.size:
        recs = recs[: neg[0]]

    mip = np.full((periodicity, num_nodes), -2, dtype=np.int16)
    probs = np.zeros((periodicity, num_nodes, 4), dtype=np.float32)
    frame_breaks = np.nonzero(recs["id"] == 0)[0]
    if len(frame_breaks) != periodicity:
        raise ValueError(
            f"{path}: found {len(frame_breaks)} frames, expected {periodicity}"
        )
    bounds = list(frame_breaks) + [len(recs)]
    for f in range(periodicity):
        fr = recs[bounds[f] : bounds[f + 1]]
        mip[f, fr["id"]] = fr["mip"]
        probs[f, fr["id"]] = fr["prob"]
    return ICM(model_len, depth, periodicity, mip, probs)


def write_icm(icm: ICM, path) -> None:
    """Write binary .icm (reference ICM_t::Output + Write_Header)."""
    header = (
        ">ver = %.2f  len = %d  depth = %d  periodicity = %d  nodes = %d\n"
        % (
            ICM_VERSION_ID / 100.0,
            icm.model_len,
            icm.model_depth,
            icm.periodicity,
            icm.num_nodes,
        )
    ).encode("latin-1")
    assert len(header) < ID_STRING_LEN
    header = header + b"\0" * (ID_STRING_LEN - len(header))

    with open(path, "wb") as fh:
        fh.write(header)
        fh.write(
            struct.pack(
                "<6i",
                ICM_VERSION_ID,
                ID_STRING_LEN,
                icm.model_len,
                icm.model_depth,
                icm.periodicity,
                icm.num_nodes,
            )
        )
        for f in range(icm.periodicity):
            keep = np.nonzero(icm.mip[f] >= -1)[0]
            if keep.size == 0 or keep[0] != 0:
                keep = np.concatenate([[0], keep])  # node 0 always written
            recs = np.empty(keep.size, dtype=_NODE_STRUCT)
            recs["id"] = keep
            recs["prob"] = icm.probs[f, keep]
            recs["mip"] = icm.mip[f, keep]
            fh.write(recs.tobytes())
        fh.write(struct.pack("<i", -1))


# ---------------------------------------------------------------------------
# Exact (numpy, float64-accumulating) scoring — the host-side parity oracle.
# The TPU kernels live in ops/icm_score.py; this version defines the
# semantics they are tested against.
# ---------------------------------------------------------------------------


def _walk_full(icm: ICM, window_idx: np.ndarray, frame: int) -> float:
    """Reference Full_Window_Prob (icm.cc:557): one window of model_len bases."""
    mip = icm.mip[frame]
    node = 0
    for _ in range(icm.model_depth):
        pos = mip[node]
        if pos < 0:
            break
        node = 4 * node + int(window_idx[pos]) + 1
    if mip[node] <= -2:
        node = (node - 1) // 4
    return float(icm.probs[frame, node, int(window_idx[icm.model_len - 1])])


def _walk_partial(icm: ICM, prefix_idx: np.ndarray, predict_pos: int, frame: int) -> float:
    """Reference Partial_Window_Prob (icm.cc:807)."""
    mip = icm.mip[frame]
    start = predict_pos - (icm.model_len - 1)
    node = 0
    for _ in range(icm.model_depth):
        pos = start + mip[node]
        if pos < 0:
            break
        node = 4 * node + int(prefix_idx[pos]) + 1
    if mip[node] == -2:
        node = (node - 1) // 4
    return float(icm.probs[frame, node, int(prefix_idx[predict_pos])])


def per_base_logprob(icm: ICM, base_idx: np.ndarray, frame: int, cycle: bool = True) -> np.ndarray:
    """Per-base log-probs; ``cycle`` cycles the frame per base (Score_String /
    Cumulative_Score semantics) vs. a fixed frame (Frame_Score semantics)."""
    if icm.periodicity == 1:
        frame = 0
    n = len(base_idx)
    out = np.zeros(n, dtype=np.float64)
    f = frame
    for i in range(min(icm.model_len - 1, n)):
        out[i] = _walk_partial(icm, base_idx, i, f)
        if cycle:
            f = (f + 1) % icm.periodicity
    for i in range(icm.model_len - 1, n):
        out[i] = _walk_full(icm, base_idx[i - icm.model_len + 1 : i + 1], f)
        if cycle:
            f = (f + 1) % icm.periodicity
    return out


def score_string(icm: ICM, base_idx: np.ndarray, frame: int) -> float:
    """Reference Score_String (icm.cc:864): total log-prob, f64 accumulation."""
    return float(np.add.reduce(per_base_logprob(icm, base_idx, frame, cycle=True)))


def cumulative_score(icm: ICM, base_idx: np.ndarray, frame: int) -> np.ndarray:
    """Reference Cumulative_Score (icm.cc:354): per-base running totals."""
    return np.cumsum(per_base_logprob(icm, base_idx, frame, cycle=True))


def frame_score(icm: ICM, base_idx: np.ndarray, frame: int) -> np.ndarray:
    """Reference Frame_Score (icm.cc:485): per-base scores at a FIXED frame."""
    return per_base_logprob(icm, base_idx, frame, cycle=False)


def per_base_logprob_vec(
    icm: ICM, base_idx: np.ndarray, frame: int, cycle: bool = True
) -> np.ndarray:
    """Vectorized per-base log-probs (numpy mirror of ops/icm_score.py).

    Returns the exact float32 table entries (bit-identical to the scalar
    walk); callers accumulate in float64 to match the C++ double sums.
    """
    if icm.periodicity == 1:
        frame = 0
    w = icm.model_len - 1
    s = np.asarray(base_idx, dtype=np.int64)
    n = len(s)
    if n == 0:
        return np.zeros(0, dtype=np.float32)
    padded = np.concatenate([np.zeros(w, dtype=np.int64), s])
    ctx = np.zeros(n, dtype=np.int64)
    for k in range(w):
        ctx |= padded[k : k + n] << (2 * k)

    i = np.arange(n, dtype=np.int64)
    thresh = np.maximum(0, w - i)
    if cycle:
        fr = (frame + i) % icm.periodicity
    else:
        fr = np.full(n, frame % icm.periodicity, dtype=np.int64)

    mip = icm.mip.astype(np.int64)
    node = np.zeros(n, dtype=np.int64)
    done = np.zeros(n, dtype=bool)
    for _ in range(icm.model_depth):
        pos = mip[fr, node]
        avail = pos >= thresh
        b = (ctx >> (2 * np.maximum(pos, 0))) & 3
        node = np.where(done | ~avail, node, 4 * node + b + 1)
        done |= ~avail
    pos = mip[fr, node]
    node = np.where(pos == -2, (node - 1) // 4, node)
    return icm.probs[fr, node, s]


def per_base_logprob_heads(
    icm: ICM, heads: np.ndarray, frame0: int = 1
) -> np.ndarray:
    """Batched per-base log-probs for the FIRST positions of many buffers.

    ``heads`` is (B, H) base indices with H <= model_len-1; each row is
    treated as the start of a fresh string (partial context windows), with
    cycling frames from ``frame0`` — exactly per_base_logprob_vec on each
    row's prefix, but one vectorized walk for all rows (the per-ORF
    partial-window fix of engine.glimmer3.G3Precompute batches through
    here).  Returns (B, H) float32, bit-identical per row.
    """
    if icm.periodicity == 1:
        frame0 = 0
    w = icm.model_len - 1
    b, h = heads.shape
    if b == 0 or h == 0:
        return np.zeros((b, h), dtype=np.float32)
    s = np.asarray(heads, dtype=np.int64)
    padded = np.concatenate([np.zeros((b, w), dtype=np.int64), s], axis=1)
    ctx = np.zeros((b, h), dtype=np.int64)
    for k in range(w):
        ctx |= padded[:, k : k + h] << (2 * k)

    j = np.arange(h, dtype=np.int64)[None, :]
    thresh = np.broadcast_to(np.maximum(0, w - j), (b, h))
    fr = np.broadcast_to((frame0 + j) % icm.periodicity, (b, h))

    mip = icm.mip.astype(np.int64)
    node = np.zeros((b, h), dtype=np.int64)
    done = np.zeros((b, h), dtype=bool)
    for _ in range(icm.model_depth):
        pos = mip[fr, node]
        avail = pos >= thresh
        bb = (ctx >> (2 * np.maximum(pos, 0))) & 3
        node = np.where(done | ~avail, node, 4 * node + bb + 1)
        done |= ~avail
    pos = mip[fr, node]
    node = np.where(pos == -2, (node - 1) // 4, node)
    return icm.probs[fr, node, s]


# ---------------------------------------------------------------------------
# Analytic null models
# ---------------------------------------------------------------------------


def _fill_codon_tree(codon_prob: np.ndarray) -> ICM:
    """Shared tail of Build_Indep_WO_Stops / Build_Reverse_Codon_WO_Stops
    (icm.cc:137-216): distribute 64 codon probs into a (3,2,3) ICM tree.

    ``codon_prob[j]`` is indexed with j = b0 + 4*b1 + 16*b2 over the
    *reversed* codon string (first reversed base = least-significant digit).
    """
    codon_prob = codon_prob / np.add.reduce(codon_prob)
    icm = ICM.empty(model_len=3, depth=2, periodicity=3)
    # The reference accumulates straight into the float32 prob fields
    # (icm.cc:160-198: `p->prob[...] += codon_prob[j]` with prob a float),
    # rounding after EVERY addition — np.add.at on a float32 array with
    # float64 addends reproduces that per-element cast-on-store.
    probs = np.zeros((3, 21, 4), dtype=np.float32)
    j = np.arange(64)

    for i in range(3):
        d1 = 4 ** ((3 - i) % 3)
        icm.mip[i, 0] = -1 if i == 1 else 1
        np.add.at(probs[i, 0], (j // d1) % 4, codon_prob)

    for i in range(3):
        d1 = 4 ** ((3 - i) % 3)
        d2 = 4 ** ((4 - i) % 3)
        icm.mip[i, 1:5] = -1 if i == 2 else 0
        if i != 1:
            np.add.at(probs[i], (1 + (j // d2) % 4, (j // d1) % 4), codon_prob)

    i = 0
    d1, d2, d3 = 4 ** ((3 - i) % 3), 4 ** ((4 - i) % 3), 4 ** ((5 - i) % 3)
    icm.mip[0, 5:21] = -1
    np.add.at(probs[0], (5 + 4 * ((j // d2) % 4) + (j // d3) % 4, (j // d1) % 4), codon_prob)

    # Normalize + log in float64 (C: double sum of the float probs, then
    # log(prob/sum) stored float; icm.cc:201-211).
    p64 = probs.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        sums = p64.sum(axis=-1, keepdims=True)
        norm = np.where(
            sums == 0.0,
            0.0,
            np.log(np.where(sums > 0, p64 / np.where(sums == 0, 1, sums), 1.0)),
        )
    icm.probs = norm.astype(np.float32)
    # Unreached nodes in frames 1, 2 stay prob 0 / mip 0 like the reference's
    # calloc'd arrays; mark nothing pruned.
    return icm


def build_indep_wo_stops(gc_frac: float, stop_codons) -> ICM:
    """Reference Build_Indep_WO_Stops (icm.cc:65): GC-only null model with
    (reversed) stop codons given probability 1e-20 before normalization."""
    from . import dna

    base_prob = np.empty(4, dtype=np.float64)
    base_prob[1] = base_prob[2] = gc_frac / 2.0
    base_prob[0] = base_prob[3] = 0.5 - base_prob[1]

    b0, b1, b2 = np.meshgrid(np.arange(4), np.arange(4), np.arange(4), indexing="ij")
    # pattern increments little-endian in pattern[2]; codon_prob index j has
    # pattern[0] changing slowest: j = 16*p0 + 4*p1 + p2 ... actually the
    # reference increments pattern[2] fastest while j increments, so
    # j = p0*16 + p1*4 + p2 with prob = b[p0]*b[p1]*b[p2] — symmetric anyway.
    codon_prob = np.empty(64, dtype=np.float64)
    for jj in range(64):
        p0, p1, p2 = jj // 16, (jj // 4) % 4, jj % 4
        codon_prob[jj] = base_prob[p0] * base_prob[p1] * base_prob[p2]

    for sc in stop_codons:
        idx = dna.encode(sc)
        jj = int(idx[0]) + 4 * int(idx[1]) + 16 * int(idx[2])
        codon_prob[jj] = 1e-20
    return _fill_codon_tree(codon_prob)


def build_reverse_codon_wo_stops(codon_prob: np.ndarray, stop_codons) -> ICM:
    """Reference Build_Reverse_Codon_WO_Stops (icm.cc:220)."""
    from . import dna

    codon_prob = np.array(codon_prob, dtype=np.float64)
    for sc in stop_codons:
        idx = dna.encode(sc)
        jj = int(idx[0]) + 4 * int(idx[1]) + 16 * int(idx[2])
        codon_prob[jj] = 1e-20
    return _fill_codon_tree(codon_prob)
