# Frozen copy of glimmer_mg_torch/engine/mg_host.py at commit ab5a5d3.
"""Host half of the glimmer-mg per-read engine (reference
src/Glimmer/glimmer-mg.cc), copied from ``glimmer_mg_tpu.engine.glimmer_mg``
without its device and native routing.

The exact per-read host engine (``predict_read``,
``_predict_read_with_models``: 6-frame LLR precompute on the host, ORF
scoring with substitution pass-through and frame-shift branching, the
event DP and traceback) is the parity reference the port's device path
is held to. Also the classes emission order, the .predict formatter and
the cache helpers the device path shares.
"""

from __future__ import annotations

import itertools

import numpy as np

from ..models import dna, icm as icm_mod
from . import events as ev_mod
from . import orfs as orf_mod
from .glimmer3 import Models, PwmScorer, Start

INDEL_SUFFIX_SCORE_THRESHOLD = -12.0
INDEL_QUALITY_THRESHOLD = 18
INDEL_MAX = 2
MIN_INDEL_ORF_LEN = 15


class Error:
    """Error_t (gene.hh:138): pos 1-based; type 0=ins, 1=del, 2=sub."""

    __slots__ = ("pos", "type")

    def __init__(self, pos, type):
        self.pos = pos
        self.type = type

    def __eq__(self, o):
        return (self.pos, self.type) == (o.pos, o.type)

    def __hash__(self):
        return hash((self.pos, self.type))

    def __repr__(self):
        return f"Err({self.pos},{'ids'[self.type]})"


def set_quality_454(seq: str) -> list[int]:
    """Synthesize 454-style qualities from homopolymer runs (mg.cc:1865)."""
    run_q = [31 - 5 * q for q in range(6)]  # {31,26,21,16,11,6}
    n = len(seq)
    qv = [0] * n
    run = 0
    last = None
    for i, ch in enumerate(seq):
        if ch != last:
            if i > 0:
                qv[i - 1] = run_q[run] if run < len(run_q) else run_q[-1]
            run = 1
        else:
            qv[i - 1] = 31
            run += 1
        last = ch
    if n:
        qv[n - 1] = run_q[run] if run < len(run_q) else run_q[-1]
    return qv


def clean_quality_454(seq: str, quals: list[int]) -> list[int]:
    """Clean_Quality_454 (mg.cc:519): floor at 1; in homopolymers only the
    final base keeps its low quality."""
    qv = [max(1, q) for q in quals]
    if len(qv) != len(seq):
        raise ValueError("sequence length does not match quality values length")
    for i in range(1, len(seq)):
        if seq[i] == seq[i - 1]:
            qv[i - 1] = max(qv[i - 1], INDEL_QUALITY_THRESHOLD + 1)
    return qv


def host_frame_scores(models: Models, seq_idx: np.ndarray) -> np.ndarray:
    """Score_All_Frames (mg.cc:1468) on host via the numpy walk mirror —
    the parity oracle for the device batch path."""
    n = len(seq_idx)
    frame_scores = np.zeros((6, n), dtype=np.float64)
    # forward frames from the reversed sequence…
    rev = seq_idx[::-1]
    for f in range(3):
        g = icm_mod.per_base_logprob_vec(models.gene_icm, rev, f, cycle=False)
        nn = icm_mod.per_base_logprob_vec(models.indep_model, rev, f, cycle=False)
        frame_scores[f] = g.astype(np.float64)[::-1] - nn.astype(np.float64)[::-1]
    # …reverse frames from the complemented (unreversed) sequence.
    comp = dna.COMPLEMENT_INDEX[seq_idx]
    for f in range(3):
        g = icm_mod.per_base_logprob_vec(models.gene_icm, comp, f, cycle=False)
        nn = icm_mod.per_base_logprob_vec(models.indep_model, comp, f, cycle=False)
        frame_scores[3 + f] = g.astype(np.float64) - nn.astype(np.float64)
    return frame_scores


def _bucket(x: int, step: int = 256) -> int:
    return max(step, -(-x // step) * step)


_SERIAL = itertools.count()


def _stable_tag(obj, kind: str):
    """Process-unique, never-reused identity for process-wide cache keys.

    ``id()`` can be reused after the object is garbage-collected, so a
    module-global cache keyed on it can silently serve a stale bank built
    from a dead object's tables (r4 advisor, medium). The serial is
    stamped on the object once and never reissued.
    """
    tag = getattr(obj, "_gmg_cache_serial", None)
    if tag is None:
        tag = (kind, next(_SERIAL))
        try:
            object.__setattr__(obj, "_gmg_cache_serial", tag)
        except Exception:
            pass  # unsettable object: fresh tag per call (cache miss, safe)
    return tag


def _lru_put(cache, key, val, cap: int) -> None:
    """Insert into an OrderedDict LRU bounded at ``cap`` entries."""
    cache[key] = val
    cache.move_to_end(key)
    while len(cache) > cap:
        cache.popitem(last=False)


class MgSequenceState:
    """Per-read precomputed state: 6-frame LLRs + stop indexes."""

    def __init__(self, models: Models, seq_idx: np.ndarray, frame_scores=None):
        self.m = models
        self.seq = seq_idx
        n = len(seq_idx)
        self.n = n
        if frame_scores is None:
            frame_scores = host_frame_scores(models, seq_idx)
        self.frame_scores = frame_scores

        self._save_prev_stops()

    def _save_prev_stops(self):
        """Save_Prev_Stops (mg.cc:675): per-position previous fwd stop / next
        rev stop in the position's frame (0-based codon-boundary indexes).
        Vectorized as per-frame running max/min scans."""
        n = self.n
        masks = np.array([1, 2, 4, 8], dtype=np.uint8)[self.seq]
        cod = dna.codon12_stream(masks)
        fwd_stop = dna.must_be(cod, self.m.patterns.fwd_stop)

        self.fwd_prev = np.empty(n, dtype=np.int64)
        init_f = (0, 1, -1)
        for f in range(3):
            idx = np.arange(f, n, 3)
            if len(idx) == 0:
                continue
            hit = (idx >= 2) & fwd_stop[idx]
            vals = np.where(hit, idx, np.int64(-(10**9)))
            run = np.maximum.accumulate(
                np.concatenate(([np.int64(init_f[f])], vals))
            )[1:]
            self.fwd_prev[idx] = run

        # reverse: stops detected scanning right-to-left over revcomp codons;
        # a rev stop with 0-based first base i is flagged by rev_stop[i+2]
        # in the forward codon stream.
        rev_stop = dna.must_be(cod, self.m.patterns.rev_stop)
        self.rev_next = np.empty(n, dtype=np.int64)
        init_r = (n - 1, n - 2, n)
        for f in range(3):
            # i with (n-1-i) % 3 == f, scanned right-to-left
            idx = np.arange(n - 1 - f, -1, -3)
            if len(idx) == 0:
                continue
            hit = (idx <= n - 3) & rev_stop[np.minimum(idx + 2, n - 1)]
            vals = np.where(hit, idx, np.int64(10**9))
            run = np.minimum.accumulate(
                np.concatenate(([np.int64(init_r[f])], vals))
            )[1:]
            self.rev_next[idx] = run

    def fwd_prev_stop(self, end_point: int) -> int:
        if 0 <= end_point < self.n:
            return int(self.fwd_prev[end_point])
        return end_point

    def rev_next_stop(self, end_point: int) -> int:
        if 0 <= end_point < self.n:
            return int(self.rev_next[end_point])
        return end_point

    def cumulative_frame_score(self, frame: int, lo: int, hi: int) -> np.ndarray:
        """Cumulative_Frame_Score (mg.cc:561): cumsum of cached LLRs, frame
        cycling starting at 1 (the '0,2,1 codon order' quirk)."""
        length = hi - lo
        if length <= 0:
            return np.zeros(max(0, length), dtype=np.float64)
        if frame > 0:
            si = np.arange(hi - 1, lo - 1, -1)
            f = (1 + np.arange(length)) % 3
            vals = self.frame_scores[f, si]
        else:
            si = np.arange(lo - 1, hi - 1)
            f = 3 + (1 + np.arange(length)) % 3
            vals = self.frame_scores[f, si]
        return np.cumsum(vals)


def pass_stop_penalty(models, seq_str, quals, frame, lo, hi) -> float:
    """Pass_Stop_Penalty (mg.cc:961)."""
    import math

    default_p = 0.999
    if frame > 0:
        stop_i = [lo - 3, lo - 2, lo - 1]
    else:
        stop_i = [hi + 1, hi, hi - 1]
    if quals is not None:
        codon_p = [1.0 - 10.0 ** (-float(quals[s]) / 10.0) for s in stop_i]
    else:
        codon_p = [default_p] * 3
    p_stop = codon_p[0]
    mid = seq_str[stop_i[1]]
    if (frame > 0 and mid == "a") or (frame < 0 and mid == "t"):
        p_stop *= 2.0 / 3.0 * codon_p[1] + 1.0 / 3.0
    else:
        p_stop *= codon_p[1]
    last = seq_str[stop_i[2]]
    if (frame > 0 and last == "a") or (frame < 0 and last == "t"):
        p_stop *= 2.0 / 3.0 * codon_p[2] + 1.0 / 3.0
    else:
        p_stop *= codon_p[2]
    return math.log(1.0 - p_stop) - math.log(p_stop)


class MgScorer:
    """Score_Orfs_Errors / Score_Orf_Starts / Score_Indels."""

    def __init__(self, models: Models, seq_str: str, seq_idx, state, quals,
                 allow_indels=False, allow_subs=False, have_qual_file=False):
        self.m = models
        self.seq_str = seq_str
        self.seq = seq_idx
        self.state = state
        self.quals = quals
        self.allow_indels = allow_indels
        self.allow_subs = allow_subs
        self.have_qual_file = have_qual_file
        masks_of = np.array([1, 2, 4, 8], dtype=np.int32)
        self.masks = masks_of[seq_idx]
        self.comp_masks = masks_of[dna.COMPLEMENT_INDEX[seq_idx]]

    def score_orf_starts(self, orf, start_list, end_point, suffix_score,
                         suffix_j, errors):
        """mg.cc:1693."""
        m = self.m
        st = self.state
        n = st.n
        frame = orf.frame

        if frame > 0:
            hi = end_point
            lo = st.fwd_prev_stop(end_point - 1) + 1
            length = hi - lo
            orf_is_truncated = lo < 3 and m.allow_truncated_orfs
            k = lo - 1
            if length >= 0:
                # reversed buffer masks: buff[j] = seq[hi-1-j]
                bidx = np.arange(hi - 1, hi - 1 - length, -1)
                bm = self.masks[bidx] if length > 0 else np.zeros(0, np.int32)
                bq = (
                    [self.quals[i] for i in bidx]
                    if self.quals is not None
                    else None
                )
            else:
                bm, bq = np.zeros(0, np.int32), None
        else:
            lo = end_point
            hi = st.rev_next_stop(end_point - 1) + 1
            length = hi - lo
            orf_is_truncated = (n - (hi - 1)) < 3 and m.allow_truncated_orfs
            k = hi + 1
            if lo - 1 < n:
                bidx = np.arange(lo - 1, lo - 1 + length)
                bm = self.comp_masks[bidx] if length > 0 else np.zeros(0, np.int32)
                bq = (
                    [self.quals[i] for i in bidx]
                    if self.quals is not None
                    else None
                )
            else:
                bm, bq = np.zeros(0, np.int32), None

        score = st.cumulative_frame_score(frame, lo, hi)

        # -- substitution branch: mutate previous stop codon (mg.cc:1769) --
        if self.allow_subs and len(errors) < 1:
            if frame > 0:
                error_end_point = lo - 3
                error_pos = lo - 2
            else:
                error_end_point = hi + 3
                error_pos = hi + 2
            if error_end_point >= 0 and error_end_point - 2 < n:
                error_suffix_j = suffix_j + length
                error_suffix_score = suffix_score + pass_stop_penalty(
                    m, self.seq_str, self.quals if self.have_qual_file else None,
                    frame, lo, hi,
                )
                if len(score):
                    error_suffix_score += float(score[-1])
                self.score_orf_starts(
                    orf, start_list, error_end_point, error_suffix_score,
                    error_suffix_j, errors + [Error(error_pos, 2)],
                )

        # -- start scanning (with indel branching) --
        mm = len(score)
        if mm:
            cod = np.zeros(mm, dtype=np.int32)
            cod |= bm
            cod[: mm - 1] |= bm[1:] << 4
            cod[: mm - 2] |= bm[2:] << 8
            can_any = dna.can_be(cod, m.patterns.fwd_start)
            whichs = np.full(mm, -1, dtype=np.int64)
            for pi in range(len(m.patterns.fwd_start) - 1, -1, -1):
                hit = dna.can_be(cod, m.patterns.fwd_start[pi : pi + 1])
                whichs[hit] = pi
        # Sparse rewrite of the reference's dense descending-j scan
        # (glimmer-mg.cc:1769-1860): only positions that can actually fire —
        # possible starts (j % 3 == 0, Can_Be, length bound) and low-quality
        # indel-branch bases — are visited, in the exact original order
        # (indel branch before the start at equal j; the truncated-ORF
        # "first position counts even without a start codon" rule tracked
        # via first_pos exactly as the dense loop does).
        lowest_j = min(3, m.min_gene_len - 3)
        first_pos = 0
        dir_ = 1 if frame > 0 else -1

        if mm:
            min_j = max(lowest_j, m.min_gene_len - 3 - suffix_j)
            top_j = ((mm - 1) // 3) * 3
            start_j = np.arange(top_j, min_j - 1, -3, dtype=np.int64)
            can_pos = (
                np.nonzero(can_any[start_j])[0] if len(start_j)
                else np.zeros(0, dtype=np.int64)
            )
        else:
            top_j = -1
            start_j = np.zeros(0, dtype=np.int64)
            can_pos = np.zeros(0, dtype=np.int64)

        if (self.allow_indels and bq is not None and len(errors) < INDEL_MAX
                and mm):
            bq_arr = np.asarray(bq, dtype=np.int64)
            ij = np.nonzero(bq_arr <= INDEL_QUALITY_THRESHOLD)[0]
            ij = ij[ij >= lowest_j][::-1]  # descending j
        else:
            bq_arr = None
            ij = np.zeros(0, dtype=np.int64)

        si = 0  # next unconsidered index into start_j (descending)
        ci = 0  # pointer into can_pos
        ii = 0  # pointer into ij
        n_start = len(start_j)
        n_can = len(can_pos)
        n_ij = len(ij)
        while True:
            ns = -1
            if si < n_start:
                if first_pos == 0 and orf_is_truncated:
                    ns = int(start_j[si])
                else:
                    while ci < n_can and can_pos[ci] < si:
                        ci += 1
                    if ci < n_can:
                        ns = int(start_j[can_pos[ci]])
            ni = int(ij[ii]) if ii < n_ij else -1
            if ns < 0 and ni < 0:
                break
            if ni >= 0 and ni >= ns:  # indel branch fires before the start
                j = ni
                ii += 1
                kk = k + dir_ * (mm - 1 - j)
                self._score_indels(
                    orf, start_list, errors, suffix_score, suffix_j, score,
                    int(bq_arr[j]), kk, j,
                )
                continue
            j = ns
            si = (top_j - j) // 3 + 1  # index of j in start_j, advanced past
            kk = k + dir_ * (mm - 1 - j)
            which = int(whichs[j])
            next_s = float(score[j - 1])
            first_flag = first_pos == 0
            base = Start(
                j + 2 + suffix_j, kk, next_s + suffix_score, first_flag,
                which, which < 0, tuple(errors),
            )
            if which >= 0 and first_pos == 0 and orf_is_truncated:
                start_list.append(
                    Start(base.j, kk, base.score, first_flag, -1, True,
                          tuple(errors))
                )
                base.first = False
            start_list.append(base)
            if first_pos == 0:
                first_pos = kk

    def _score_indels(self, orf, start_list, errors, suffix_score, suffix_j,
                      score, q, k, j):
        """Score_Indels (mg.cc:1513)."""
        import math

        frame = orf.frame
        prob_err = 10.0 ** (-float(q) / 10.0)
        penalty = math.log(prob_err / 2.0) - math.log(1.0 - prob_err)

        if frame > 0:
            branches = [
                # (llr index, new end point, error)
                (j, k + (j % 3), Error(k + 3, 1)),  # deletion
                (j - 1, k - (2 - (j % 3)), Error(k + 2, 0)),  # insertion
            ]
        else:
            branches = [
                (j, k - (j % 3), Error(k - 1, 1)),
                (j - 1, k + 2 - (j % 3), Error(k - 2, 0)),
            ]
        for sidx, end_point, err in branches:
            ess = suffix_score + float(score[sidx]) + penalty
            if ess > INDEL_SUFFIX_SCORE_THRESHOLD:
                esj = suffix_j + j + 2 - (j % 3)
                self.score_orf_starts(
                    orf, start_list, end_point, ess, esj, errors + [err]
                )


def score_orfs_errors(models, scorer, orf_list, engine, pwm_scorer):
    """Score_Orfs_Errors (mg.cc:1605)."""
    m = models
    for orf in orf_list:
        frame = orf.frame
        start_list: list[Start] = []
        if frame > 0:
            end_point = orf.stop_position - 1
        else:
            end_point = orf.stop_position + 3
        scorer.score_orf_starts(orf, start_list, end_point, 0.0, 0, [])

        for s in start_list:
            if s.j > m.ignore_score_len:
                s.score = max(0.0, s.score)

        if not start_list:
            continue
        from ..utils.stdsort import std_sort

        std_sort(start_list, lambda a, b: a.pos < b.pos)  # std::sort w/ Start_Cmp
        first_j = start_list[0].j if frame > 0 else start_list[-1].j
        if first_j + 1 < m.min_gene_len:
            continue
        best_score = max(s.score for s in start_list)
        if best_score > m.start_threshold:
            if frame > 0:
                engine.add_events_fwd(orf, start_list, pwm_scorer)
            else:
                engine.add_events_rev(orf, start_list, pwm_scorer)


def predict_read(models: Models, seq: str, quals=None, *, allow_indels=False,
                 allow_subs=False, have_qual_file=False, frame_scores=None):
    """Full per-read pipeline; returns traced genes (with errors)."""
    return _predict_read_with_models(
        models, seq, quals, allow_indels=allow_indels, allow_subs=allow_subs,
        have_qual_file=have_qual_file, frame_scores=frame_scores,
        use_meta_pwms=False,
    )


class MetaPwmScorer:
    """RBS scoring against a mixture of class PWMs with per-position
    memoization (PWM_Meta_Score_Fwd/Rev_Start, glimmer-mg.cc:1900-2060)."""

    def __init__(self, models: Models, seq_idx: np.ndarray, pwms):
        import math

        self.m = models
        self.seq = seq_idx
        self.n = len(seq_idx)
        self.pwms = pwms  # raw-probability PWMs
        self.cache: dict[int, tuple] = {}
        gc = models.indep_gc_frac
        gc_log = math.log(0.5 * gc)
        at_log = math.log(0.5 * (1.0 - gc))
        self.nt_lp = np.array([at_log, gc_log, gc_log, at_log])
        self._precompute()

    def _precompute(self) -> None:
        """Vectorize the per-window mixture probabilities over the whole read.

        ``mix_fwd[lo]`` = mean over class PWMs of prod_j cols[j, seq[lo+j]]
        (the value whose libm log the scalar scorer takes); ``gc_fwd[lo]`` =
        the GC-background log-prob sum. The chained elementwise multiplies /
        adds reproduce np.prod / .sum() over the 6-wide window bitwise
        (sequential order below the pairwise-reduction blocksize), and the
        log itself stays scalar math.log in fwd/rev_start, so scores are
        bit-identical to the reference's per-window loop
        (PWM_Meta_Score_Fwd/Rev_Start, glimmer-mg.cc:1900-2060)."""
        self.mix_fwd = self.gc_fwd = self.mix_rev = self.gc_rev = None
        if not self.pwms:
            return
        width = self.pwms[0].width
        n = self.n
        nw = n - width + 1
        if nw <= 0:
            return
        s = self.seq.astype(np.int64)
        comp = dna.COMPLEMENT_INDEX[self.seq].astype(np.int64)

        acc = np.zeros(nw, dtype=np.float64)
        for p in self.pwms:
            prod = np.ones(nw, dtype=np.float64)
            for j in range(width):
                prod = prod * p.cols[j, s[j : j + nw]]
            acc = acc + prod
        self.mix_fwd = acc / len(self.pwms)
        g = np.zeros(nw, dtype=np.float64)
        for j in range(width):
            g = g + self.nt_lp[s[j : j + nw]]
        self.gc_fwd = g

        # rev window "ending" at hi (hi in [width-1, n-1]): window[j] =
        # comp(seq[hi - j]); stored at index hi - (width - 1).
        acc = np.zeros(nw, dtype=np.float64)
        for p in self.pwms:
            prod = np.ones(nw, dtype=np.float64)
            for j in range(width):
                prod = prod * p.cols[j, comp[width - 1 - j : n - j]]
            acc = acc + prod
        self.mix_rev = acc / len(self.pwms)
        g = np.zeros(nw, dtype=np.float64)
        for j in range(width):
            g = g + self.nt_lp[comp[width - 1 - j : n - j]]
        self.gc_rev = g

    def fwd_start(self, pos: int):
        import math

        if not self.pwms:
            return 0.0, 0
        key = pos - 1
        if key in self.cache:
            return self.cache[key]
        n = self.pwms[0].width
        bottom = pos - self.m.ribosome_window_size - 1
        score = -np.inf
        best_sep = sep = 0
        lo = pos - n - 1
        while lo >= 0 and lo >= bottom:
            sc = math.log(self.mix_fwd[lo]) - self.gc_fwd[lo]
            if sc > score:
                score = sc
                best_sep = sep
            lo -= 1
            sep += 1
        out = (score, best_sep)
        self.cache[key] = out
        return out

    def rev_start(self, pos: int):
        import math

        if not self.pwms:
            return 0.0, 0
        key = self.n + pos - 1
        if key in self.cache:
            return self.cache[key]
        n = self.pwms[0].width
        top = pos - 1 + self.m.ribosome_window_size
        score = -np.inf
        best_sep = sep = 0
        hi = pos - 1 + n
        while hi < self.n and hi <= top:
            sc = math.log(self.mix_rev[hi - (n - 1)]) - self.gc_rev[hi - (n - 1)]
            if sc > score:
                score = sc
                best_sep = sep
            hi += 1
            sep += 1
        out = (score, best_sep)
        self.cache[key] = out
        return out


def classes_emission_order(genome_data, classifications: dict) -> list[str]:
    """Reference emission order of classified reads (glimmer-mg.cc:361):
    reads grouped by gene-ICM file, groups in __gnu_cxx::hash_map iteration
    order over the ICM paths, reads within a group in the
    `classifications` hash_map order (Read_Meta_ICMs, glimmer-mg.cc:1001);
    unclassified reads are never emitted. Duplicate prefixes: the last
    read wins (Read_Indexes) and is emitted once.

    A pure function of the class map — any process can compute it, so
    read-sharded multi-process prediction can take contiguous slices whose
    concatenated outputs are byte-equal to the single-process run
    (reference combine_seq merge semantics, phymm_par.py:283-399).
    """
    from ..utils.gnuhash import GnuHashMap, gnu_hash_order

    icm_groups = GnuHashMap()
    for prefix in gnu_hash_order(list(classifications.keys())):
        cl = classifications.get(prefix)
        if not cl:
            continue
        f = genome_data.classes_icm_file(cl)
        if f in icm_groups:
            icm_groups[f].append(prefix)
        else:
            icm_groups.insert(f, [prefix])
    return [p for _f, prefixes in icm_groups.items() for p in prefixes]


def _predict_read_with_models(models, seq, quals=None, *, allow_indels=False,
                              allow_subs=False, have_qual_file=False,
                              frame_scores=None, use_meta_pwms=True):
    """predict_read but honoring models._meta_pwms for RBS scoring."""
    seq_idx = dna.encode(seq) if isinstance(seq, (str, bytes)) else seq
    seq_str = dna.decode(seq_idx)
    n = len(seq_idx)
    masks = np.array([1, 2, 4, 8], dtype=np.uint8)[seq_idx]

    if allow_indels:
        if not have_qual_file or quals is None:
            quals = set_quality_454(seq_str)
        else:
            quals = clean_quality_454(seq_str, quals)

    orf_list = orf_mod.find_orfs(
        masks, models.patterns,
        min_gene_len=models.min_gene_len,
        allow_truncated=models.allow_truncated_orfs,
        allow_indel_orfs=allow_indels or allow_subs,
        min_indel_orf_len=MIN_INDEL_ORF_LEN,
        circular=models.circular,
    )
    state = MgSequenceState(models, seq_idx, frame_scores=frame_scores)
    scorer = MgScorer(models, seq_str, seq_idx, state, quals,
                      allow_indels=allow_indels, allow_subs=allow_subs,
                      have_qual_file=have_qual_file)
    engine = ev_mod.EventEngine(models, n)
    meta_pwms = getattr(models, "_meta_pwms", None) if use_meta_pwms else None
    if meta_pwms is not None:
        pwm_scorer = MetaPwmScorer(models, seq_idx, meta_pwms)
    else:
        pwm_scorer = PwmScorer(models, seq_idx)
    score_orfs_errors(models, scorer, orf_list, engine, pwm_scorer)
    engine.process_events()
    final = engine.set_final_event()
    return ev_mod.trace_back(final, n)


def format_predict_mg(results) -> str:
    """glimmer-mg .predict rows with I:/D:/S: error lists (mg.cc:2023)."""
    out = []
    for header, genes in results:
        out.append(f">{header}\n")
        for g in genes:
            ins = sorted(e.pos for e in g.errors if e.type == 0)
            dels = sorted(e.pos for e in g.errors if e.type == 1)
            subs = sorted(e.pos for e in g.errors if e.type == 2)
            out.append(
                "orf%05d %8d %8d %+3d %8.2f I:%s D:%s S:%s\n"
                % (
                    g.id, g.start, g.stop, g.frame, g.score,
                    ",".join(map(str, ins)), ",".join(map(str, dels)),
                    ",".join(map(str, subs)),
                )
            )
    return "".join(out)
