"""Fixed-length ICM: one ICM per window position (reference
Fixed_Length_ICM_t / Fixed_Length_ICM_Training_t, src/ICM/icm.cc:1466-1837).

Used for fixed-length signal models (e.g. start-site windows): position i is
modeled by an ICM of length i+1 and depth min(i, max_depth), periodicity 1;
a window's score is the sum over positions of each sub-model's full-window
probability. Supports the optional base-order permutation.

Binary format: the same 150-byte header + 6 int32 params {version, 150,
length, max_depth, special_position, model_type}, then ``length`` int32
permutation entries, then each sub-model serialized like a standalone ICM
(header + params + node records + -1 sentinel).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from . import icm as icm_mod
from .icm import ICM, ICM_VERSION_ID, ID_STRING_LEN, _NODE_STRUCT


@dataclasses.dataclass
class FixedLengthICM:
    length: int
    max_depth: int
    special_position: int
    model_type: int
    permutation: np.ndarray  # (length,) int32
    sub_models: list[ICM]

    def score_window(self, base_idx: np.ndarray) -> float:
        """Score_Window (icm.cc:1565): sum of per-position window probs."""
        return self.subrange_score(base_idx, 0, self.length)

    def subrange_score(self, base_idx: np.ndarray, lo: int, hi: int) -> float:
        buff = np.asarray(base_idx)[self.permutation]
        total = 0.0
        for i in range(lo, hi):
            m = self.sub_models[i]
            total += icm_mod._walk_full(m, buff[: i + 1], 0)
        return total


def _sub_icm_bytes(m: ICM) -> bytes:
    """Serialize one sub-model exactly like ICM_t::Output (binary)."""
    header = (
        ">ver = %.2f  len = %d  depth = %d  periodicity = %d  nodes = %d\n"
        % (ICM_VERSION_ID / 100.0, m.model_len, m.model_depth, m.periodicity,
           m.num_nodes)
    ).encode("latin-1")
    header += b"\0" * (ID_STRING_LEN - len(header))
    out = [header, struct.pack("<6i", ICM_VERSION_ID, ID_STRING_LEN,
                               m.model_len, m.model_depth, m.periodicity,
                               m.num_nodes)]
    for f in range(m.periodicity):
        keep = np.nonzero(m.mip[f] >= -1)[0]
        if keep.size == 0 or keep[0] != 0:
            keep = np.concatenate([[0], keep])
        recs = np.empty(keep.size, dtype=_NODE_STRUCT)
        recs["id"] = keep
        recs["prob"] = m.probs[f, keep]
        recs["mip"] = m.mip[f, keep]
        out.append(recs.tobytes())
    out.append(struct.pack("<i", -1))
    return b"".join(out)


def write_fixed_icm(fm: FixedLengthICM, path) -> None:
    header = (
        ">ver=%.2f  len=%d  depth=%d  special=%d  type=%d"
        % (ICM_VERSION_ID / 100.0, fm.length, fm.max_depth,
           fm.special_position, fm.model_type)
    )
    header += "".join(
        ("  %d" if i == 0 else ",%d") % fm.permutation[i] for i in range(fm.length)
    )
    header += "\n"
    hb = header.encode("latin-1")
    assert len(hb) < ID_STRING_LEN
    hb += b"\0" * (ID_STRING_LEN - len(hb))
    with open(path, "wb") as fh:
        fh.write(hb)
        fh.write(struct.pack("<6i", ICM_VERSION_ID, ID_STRING_LEN, fm.length,
                             fm.max_depth, fm.special_position, fm.model_type))
        fh.write(np.asarray(fm.permutation, dtype="<i4").tobytes())
        for m in fm.sub_models:
            fh.write(_sub_icm_bytes(m))


def _parse_sub_icm(data: bytes, off: int) -> tuple[ICM, int]:
    params = struct.unpack_from("<6i", data, off + ID_STRING_LEN)
    version, id_len, model_len, depth, periodicity, num_nodes = params
    if version != ICM_VERSION_ID:
        raise ValueError(f"bad sub-model version {version}")
    off += ID_STRING_LEN + 24
    mip = np.full((periodicity, num_nodes), -2, dtype=np.int16)
    probs = np.zeros((periodicity, num_nodes, 4), dtype=np.float32)
    period = -1
    prev_node = 0
    while True:
        (node_id,) = struct.unpack_from("<i", data, off)
        off += 4
        if node_id < 0:
            break
        if node_id == 0:
            period += 1
        prob = struct.unpack_from("<4f", data, off)
        off += 16
        (mval,) = struct.unpack_from("<h", data, off)
        off += 2
        mip[period, node_id] = mval
        probs[period, node_id] = prob
        prev_node = node_id
    return ICM(model_len, depth, periodicity, mip, probs), off


def read_fixed_icm(path) -> FixedLengthICM:
    with open(path, "rb") as fh:
        data = fh.read()
    params = struct.unpack_from("<6i", data, ID_STRING_LEN)
    version, id_len, length, max_depth, special, mtype = params
    if version != ICM_VERSION_ID:
        raise ValueError(f"{path}: bad version {version}")
    off = ID_STRING_LEN + 24
    perm = np.frombuffer(data, dtype="<i4", count=length, offset=off).copy()
    off += 4 * length
    subs = []
    for _ in range(length):
        m, off = _parse_sub_icm(data, off)
        subs.append(m)
    return FixedLengthICM(length, max_depth, special, mtype, perm, subs)


def train_fixed_icm(
    strings_idx: list[np.ndarray],
    max_depth: int,
    special_position: int = -1,
    permutation=None,
    model_type: int = 0,
) -> FixedLengthICM:
    """Fixed_Length_ICM_Training_t::Train_Model (icm.cc:1713-1763)."""
    from . import icm_train

    length = len(strings_idx[0])
    for s in strings_idx:
        if len(s) != length:
            raise ValueError("training strings must share one length")
    if permutation is None:
        perm = np.arange(length, dtype=np.int32)
        data = [np.asarray(s) for s in strings_idx]
    else:
        perm = np.asarray(permutation, dtype=np.int32)
        data = [np.asarray(s)[perm] for s in strings_idx]

    subs = []
    for i in range(1, length + 1):
        depth = min(i - 1, max_depth)
        prefixes = [s[:i] for s in data]
        subs.append(
            icm_train.train_icm(prefixes, model_len=i, depth=depth, periodicity=1)
        )
    return FixedLengthICM(length, max_depth, special_position, model_type,
                          perm, subs)
