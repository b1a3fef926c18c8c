# Frozen copy of glimmer_mg_torch/engine/glimmer3.py at commit ab5a5d3;
# _use_native_g3 always answers False (no native engine in the copy).
"""glimmer3-equivalent single-genome prediction engine.

Reference: src/Glimmer/glimmer3.cc (main 156-325, Score_Orfs 1275-1552)
plus the shared machinery in glimmer_base.cc. The ICM scoring runs through
the vectorized walk (exact f32 table values, f64 cumulative sums); ORF
enumeration and the event DP are the exact host implementations in
engine.orfs / engine.events.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..models import dna, features, icm as icm_mod
from . import events as ev_mod
from . import orfs as orf_mod

INT_MAX = 2**31 - 1


@dataclasses.dataclass
class Start:
    j: int
    pos: int
    score: float
    first: bool
    which: int
    truncated: bool
    errors: tuple = ()


@dataclasses.dataclass
class Models:
    """The reference's model globals bundled per run."""

    gene_icm: icm_mod.ICM
    indep_model: icm_mod.ICM
    patterns: orf_mod.CodonPatterns
    logodds_prior: np.float32 = np.float32(-1.0)
    logodds_start: features.StartDist = dataclasses.field(
        default_factory=features.StartDist
    )
    logodds_length: features.LengthDist = dataclasses.field(
        default_factory=features.LengthDist
    )
    logodds_adj_or: features.AdjOrDist = dataclasses.field(
        default_factory=features.AdjOrDist
    )
    logodds_adj_dist: features.AdjDistDist = dataclasses.field(
        default_factory=features.AdjDistDist
    )
    logodds_pwm: features.PWM = dataclasses.field(default_factory=features.PWM)
    user_rbs: bool = False
    ribosome_window_size: int = 20
    min_gene_len: int = 75
    max_olap_bases: int = 50
    event_threshold: float = -3.0
    start_threshold: float = -6.0
    ignore_score_len: int = INT_MAX
    use_first_start_codon: bool = False
    allow_truncated_orfs: bool = False
    circular: bool = False
    indep_gc_frac: float = 0.5


def set_ignore_score_len(gc_frac: float, stop_codons) -> int:
    """glimmer_base.cc:2597-2633: Poisson-expected longest random ORF / Mbp."""
    lam = 0.0
    for sc in stop_codons:
        x = 1.0
        for ch in sc[:3]:
            if ch in "cg":
                x *= gc_frac / 2.0
            else:
                x *= (1.0 - gc_frac) / 2.0
        lam += x
    return int(math.floor(3.0 * math.log(2.0 * 1000000 * lam) / lam))


def gc_fraction(seqs) -> float:
    """Set_GC_Fraction (glimmer_base.cc:2564): over Filter()ed characters."""
    ct = 0
    total = 0
    for s in seqs:
        e = dna.encode(s)
        total += len(e)
        ct += int(((e == 1) | (e == 2)).sum())
    return ct / total


class PwmScorer:
    """Start-site RBS scoring against the full sequence.

    PWM_Score_Fwd_Start / PWM_Score_Rev_Start (glimmer_base.cc:2063-2213)
    for the user-supplied log-odds PWM; the Meta (mixture) variant returns
    (0, 0) when no meta PWMs are loaded — matching glimmer3 without -b.
    """

    def __init__(self, models: Models, seq_idx: np.ndarray):
        self.m = models
        self.seq = seq_idx
        self.n = len(seq_idx)
        pwm = models.logodds_pwm
        if models.user_rbs and not pwm.is_empty():
            w = pwm.width
            # Precompute sliding-window column-sum scores for both strands.
            cols = pwm.cols  # (w, 4) log-odds
            fwd = np.zeros(self.n - w + 1) if self.n >= w else np.zeros(0)
            rc = dna.COMPLEMENT_INDEX[seq_idx]
            rev = np.zeros(self.n - w + 1) if self.n >= w else np.zeros(0)
            for j in range(w):
                fwd += cols[j][self.seq[j : j + len(fwd)]]
                # reverse strand window starting (0-based) at q, reading
                # complement right-to-left: handled in rev_start directly.
            self.fwd_window = fwd
            self.pwm_w = w
        else:
            self.fwd_window = None
            self.pwm_w = 0

    def fwd_start(self, pos: int):
        """Best PWM match in `window` bases before 1-based position pos."""
        m = self.m
        pwm = m.logodds_pwm
        if not m.user_rbs or pwm.is_empty():
            return 0.0, 0
        n = pwm.width
        bottom = pos - m.ribosome_window_size - 1
        score = -np.inf
        sep = 0
        best_sep = 0
        lo = pos - n - 1
        while lo >= 0 and lo >= bottom:
            sc = float(self.fwd_window[lo]) if lo < len(self.fwd_window) else 0.0
            if sc > score:
                score = sc
                best_sep = sep
            lo -= 1
            sep += 1
        if score == -np.inf:
            return 0.0, 0  # no fit: mirrors ref leaving score=-DBL_MAX? see note
        return score, best_sep

    def rev_start(self, pos: int):
        m = self.m
        pwm = m.logodds_pwm
        if not m.user_rbs or pwm.is_empty():
            return 0.0, 0
        n = pwm.width
        top = pos - 1 + m.ribosome_window_size
        score = -np.inf
        sep = 0
        best_sep = 0
        hi = pos - 1 + n
        cols = pwm.cols
        while hi < self.n and hi <= top:
            window = dna.COMPLEMENT_INDEX[self.seq[hi - n + 1 : hi + 1]][::-1]
            sc = float(cols[np.arange(n), window].sum())
            if sc > score:
                score = sc
                best_sep = sep
            hi += 1
            sep += 1
        if score == -np.inf:
            return 0.0, 0
        return score, best_sep


class G3Precompute:
    """Whole-genome fixed-frame per-base log-probs for fast ORF rescoring.

    The reference rescores every ORF with a fresh tree walk over its
    reversed/complemented buffer (Score_Orfs -> Cumulative_Score,
    glimmer3.cc:1275/icm.cc:354).  Because an ORF buffer is a slice of the
    reversed (+ strand) or complemented (- strand) genome, the cycling-frame
    per-base values of every ORF are selections from SIX whole-genome
    fixed-frame passes — the same precompute glimmer-mg uses per read
    (Score_All_Frames, glimmer-mg.cc:1468), lifted to the whole genome.
    Only a buffer's first model_len-1 positions differ (the fresh buffer
    starts with partial context windows); those are recomputed per ORF.

    ``rev_*[f]``/``comp_*[f]`` hold frame-f per-base f32 log-probs over the
    reversed / complemented genome; values are bitwise equal to the
    per-ORF walk outside the partial-window head.
    """

    def __init__(self, models: Models, seq_idx: np.ndarray):
        g, ind = models.gene_icm, models.indep_model
        self._gene_icm, self._indep_icm = g, ind
        native_done = False
        try:
            from .. import native as native_mod

            if native_mod.available():
                gene6, ind6 = native_mod.fixed_frame_probs(g, ind, seq_idx)
                self.rev_gene, self.comp_gene = gene6[:3], gene6[3:]
                self.rev_ind, self.comp_ind = ind6[:3], ind6[3:]
                native_done = True
        except Exception:
            native_done = False
        if not native_done:
            rev = seq_idx[::-1]
            comp = dna.COMPLEMENT_INDEX[seq_idx]

            def six(icm):
                return (
                    np.stack([
                        icm_mod.per_base_logprob_vec(icm, rev, f, cycle=False)
                        for f in range(3)
                    ]),
                    np.stack([
                        icm_mod.per_base_logprob_vec(icm, comp, f, cycle=False)
                        for f in range(3)
                    ]),
                )

            self.rev_gene, self.comp_gene = six(g)
            self.rev_ind, self.comp_ind = six(ind)
        self.head = models.gene_icm.model_len - 1

    def batch_heads(self, head_mat: np.ndarray):
        """Batched partial-window head values for many ORF buffers
        ((n, head) padded base indices -> two (n, head) f32 arrays)."""
        return (
            icm_mod.per_base_logprob_heads(self._gene_icm, head_mat, 1),
            icm_mod.per_base_logprob_heads(self._indep_icm, head_mat, 1),
        )

    def orf_llr(self, models: Models, buff: np.ndarray, a: int, plus: bool,
                head_rows=None):
        """Cumulative gene-minus-null LLR of one ORF buffer starting at
        offset ``a`` of the reversed (plus) or complemented (minus) genome;
        the summation is a fresh per-ORF f64 cumsum exactly like the
        reference's Cumulative_Score.  ``head_rows`` supplies the
        partial-window head values from :meth:`batch_heads`."""
        mm = len(buff)
        sel = (1 + np.arange(mm)) % 3
        pos = a + np.arange(mm)
        if plus:
            gene_pb = self.rev_gene[sel, pos]
            indep_pb = self.rev_ind[sel, pos]
        else:
            gene_pb = self.comp_gene[sel, pos]
            indep_pb = self.comp_ind[sel, pos]
        head = min(self.head, mm)
        if head and a > 0:  # buffer-local partial windows differ from genome
            if head_rows is not None:
                gh, ih = head_rows
            else:
                gh = icm_mod.per_base_logprob_vec(
                    models.gene_icm, buff[:head], 1, cycle=True)
                ih = icm_mod.per_base_logprob_vec(
                    models.indep_model, buff[:head], 1, cycle=True)
            gene_pb = gene_pb.copy()
            indep_pb = indep_pb.copy()
            gene_pb[:head] = gh[:head]
            indep_pb[:head] = ih[:head]
        return np.cumsum(gene_pb.astype(np.float64)) - np.cumsum(
            indep_pb.astype(np.float64)
        )


MAX_LOG_DIFF = -46.0  # icm.hh:58
HI_SCORE = 100  # glimmer_base.hh:33


def _permute_by_frame(v: list, frame: int) -> None:
    """Permute_By_Frame (glimmer3.cc:1014): reorder 6 frame entries so they
    are relative to a reverse gene string starting at genome frame."""
    if frame == 1:
        v[0], v[1], v[2] = v[2], v[0], v[1]
        v[3], v[4], v[5] = v[5], v[3], v[4]
    elif frame == 2:
        v[0], v[1], v[2] = v[1], v[2], v[0]
        v[3], v[4], v[5] = v[4], v[5], v[3]
    elif frame == -1:
        v[0], v[3] = v[3], v[0]
        v[1], v[5] = v[5], v[1]
        v[2], v[4] = v[4], v[2]
    elif frame == -2:
        v[0], v[4] = v[4], v[0]
        v[1], v[3] = v[3], v[1]
        v[2], v[5] = v[5], v[2]
    elif frame == -3:
        v[0], v[5] = v[5], v[0]
        v[1], v[4] = v[4], v[1]
        v[2], v[3] = v[3], v[2]


def _find_stops_reverse(buff: np.ndarray, length: int, patterns) -> list:
    """Find_Stops_Reverse (glimmer3.cc:476): per-frame in-frame stop flags
    over the first ``length`` chars of the reversed gene string."""
    has_stop = [False] * 7
    masks_of = np.array([1, 2, 4, 8], dtype=np.int32)
    codon = 0
    frame_ss = 1
    for i in range(length - 1, -1, -1):
        codon = ((codon << 4) | int(masks_of[buff[i]])) & 0xFFF
        if dna.must_be(np.array([codon]), patterns.fwd_stop)[0]:
            has_stop[frame_ss] = True
        if dna.must_be(np.array([codon]), patterns.rev_stop)[0]:
            has_stop[frame_ss + 3] = True
        frame_ss = 0 if frame_ss == 2 else frame_ss + 1
    return has_stop


def _integerize_scores(ds: list, hi_score: int, set_negative: list) -> list:
    """Integerize_Scores (glimmer3.cc:597): scores -> 0..hi_score ints."""
    import math

    vals = [d for d, neg in zip(ds, set_negative) if not neg]
    mx = max(vals) if vals else 0.0
    mn = min(vals) if vals else 0.0
    if mn < mx + MAX_LOG_DIFF:
        mn = mx + MAX_LOG_DIFF
    v = []
    total = 0.0
    for d, neg in zip(ds, set_negative):
        if neg:
            v.append(-1.0)
        elif d < mn:
            v.append(0.0)
        else:
            e = math.exp(d - mn)
            v.append(e)
            total += e
    out = []
    for x, neg in zip(v, set_negative):
        if neg:
            out.append(-1)
        else:
            s = int(hi_score * (x / total))
            out.append(min(s, hi_score - 1))
    return out


def _all_frame_score(models: Models, buff: np.ndarray, length: int, fr: int):
    """All_Frame_Score (glimmer3.cc:328): 6-frame Score_String diagnostic of
    the first ``length`` chars of the reversed gene string."""
    from ..models.icm import score_string

    g = models.gene_icm
    s = buff[:length]
    rc = dna.COMPLEMENT_INDEX[s][::-1]
    af = [
        score_string(g, s, 1), score_string(g, s, 2), score_string(g, s, 0),
        score_string(g, rc, 1), score_string(g, rc, 0), score_string(g, rc, 2),
    ]
    _permute_by_frame(af, fr)
    return af


def print_headings(fp) -> None:
    """Print_Headings (glimmer_base.cc:1369), independent-score layout."""
    fp.write("\n")
    fp.write("%4s %5s %17s %8s  %15s" % ("", "", "----- Start -----", "",
                                         "--- Length ----"))
    fp.write("  %s\n" % "------------- Scores -------------")
    fp.write("%4s %5s %8s %8s %8s  %7s %7s  %7s %5s %s" %
             (" ID ", "Frame", "of Orf", "of Gene", "Stop", "of Orf",
              "of Gene", "Raw", "InFrm", "F1 F2 F3 R1 R2 R3"))
    fp.write(" NC\n")


def score_orfs(models: Models, seq_idx: np.ndarray, orf_list, engine, pwm_scorer,
               precompute: G3Precompute | None = None, detail_fp=None):
    """Score_Orfs (glimmer3.cc:1275): per-ORF start scoring + event creation.

    ``detail_fp`` enables the reference's per-ORF diagnostic table
    (glimmer3.cc:1527-1542 — compile-time-disabled there; our --detail flag
    closes that documented gap)."""
    m = models
    n = len(seq_idx)
    masks_of = np.array([1, 2, 4, 8], dtype=np.int32)

    head_rows_of = {}
    if precompute is not None and orf_list:
        # batch every ORF's partial-window head fix into one vectorized walk
        hmax = precompute.head
        idx = []
        mat = []
        for oi, orf in enumerate(orf_list):
            length = orf.orf_len
            if length == 0:
                continue
            if orf.frame > 0:
                hi = orf.stop_position - 1
                hb = seq_idx[hi - length : hi][::-1][:hmax]
                if n - hi == 0:
                    continue  # a == 0: genome-edge buffer, no fix needed
            else:
                lo = orf.stop_position + 2
                hb = dna.COMPLEMENT_INDEX[seq_idx[lo : lo + length]][:hmax]
                if lo == 0:
                    continue
            row = np.zeros(hmax, dtype=np.int64)
            row[: len(hb)] = hb
            idx.append(oi)
            mat.append(row)
        if idx:
            gh, ih = precompute.batch_heads(np.stack(mat))
            head_rows_of = {oi: (gh[r], ih[r]) for r, oi in enumerate(idx)}

    gene_ct = 0
    for oi, orf in enumerate(orf_list):
        frame = orf.frame
        length = orf.orf_len
        if frame > 0:
            hi = orf.stop_position - 1
            lo = hi - length
            # Reverse_Transfer: seq[hi-1], seq[hi-2], ... (0-based), len chars
            buff = seq_idx[hi - length : hi][::-1]
            orf_is_truncated = lo < 3 and m.allow_truncated_orfs
            k0 = orf.stop_position - length - 2
        else:
            lo = orf.stop_position + 2
            hi = lo + length
            # Complement_Transfer from 0-based subscript lo
            buff = dna.COMPLEMENT_INDEX[seq_idx[lo : lo + length]]
            orf_is_truncated = (n - hi) < 3 and m.allow_truncated_orfs
            k0 = orf.stop_position + length + 4

        mm = len(buff)
        if mm == 0:
            continue

        if precompute is not None:
            a = (n - hi) if frame > 0 else lo
            llr = precompute.orf_llr(m, buff, a, frame > 0,
                                     head_rows=head_rows_of.get(oi))
        else:
            gene_pb = icm_mod.per_base_logprob_vec(m.gene_icm, buff, 1, cycle=True)
            indep_pb = icm_mod.per_base_logprob_vec(m.indep_model, buff, 1, cycle=True)
            llr = np.cumsum(gene_pb.astype(np.float64)) - np.cumsum(
                indep_pb.astype(np.float64)
            )

        # Start-codon candidates: codon at scan index j is
        # (buff[j+2], buff[j+1], buff[j]).
        bm = masks_of[buff]
        cod = np.zeros(mm, dtype=np.int32)
        cod |= bm
        cod[: mm - 1] |= bm[1:] << 4
        cod[: mm - 2] |= bm[2:] << 8
        can_any = dna.can_be(cod, m.patterns.fwd_start)
        # first matching pattern index (reference `which`)
        whichs = np.full(mm, -1, dtype=np.int64)
        for pi in range(len(m.patterns.fwd_start) - 1, -1, -1):
            hit = dna.can_be(cod, m.patterns.fwd_start[pi : pi + 1])
            whichs[hit] = pi

        lowest_j = min(3, m.min_gene_len - 3)
        start_list: list[Start] = []
        first_pos = 0
        first_score = first_j = 0
        first_is_truncated = False
        best_score = -np.inf
        best_pos = best_j = 0
        best_is_truncated = False

        cand = np.arange(mm - 1, lowest_j - 1, -1)
        cand = cand[(cand % 3 == 0) & (cand + 3 >= m.min_gene_len)]
        for j in cand:
            j = int(j)
            if not (can_any[j] or (first_pos == 0 and orf_is_truncated)):
                continue
            which = int(whichs[j])
            next_s = float(llr[j - 1])
            k = k0 + (mm - 1 - j) if frame > 0 else k0 - (mm - 1 - j)
            first_flag = first_pos == 0

            if which >= 0 and first_pos == 0 and orf_is_truncated:
                start_list.append(
                    Start(j + 2, k, next_s, first_flag, -1, True)
                )
                first_flag = False
            start_list.append(
                Start(j + 2, k, next_s, first_flag, which, which < 0)
            )
            if first_pos == 0:
                first_score = next_s
                first_pos = k
                first_j = j + 2
                first_is_truncated = first_pos == 0 and orf_is_truncated
            if next_s > best_score:
                best_score = next_s
                best_pos = k
                best_j = j + 2
                best_is_truncated = which < 0

        if m.use_first_start_codon:
            best_score = first_score
            best_pos = first_pos
            best_j = first_j
            best_is_truncated = first_is_truncated

        if first_j + 1 < m.min_gene_len:
            continue

        # long-ORF boost (glimmer3.cc:1464-1466)
        for s in start_list:
            if s.j > m.ignore_score_len:
                s.score = max(0.0, s.score)

        is_tentative = first_j + 1 >= m.min_gene_len and best_score > m.start_threshold
        if is_tentative:
            gene_ct += 1

        if detail_fp is not None:
            # per-ORF diagnostic row (glimmer3.cc:1434-1542)
            fr = 1 + (1 + frame) % 3 if frame > 0 else frame
            if frame > 0:
                det_k, orf_start = hi + 3, lo + 1
            else:
                det_k, orf_start = lo - 2, hi
            det_best_pos = best_pos
            indep_cum = np.cumsum(
                icm_mod.per_base_logprob_vec(
                    m.indep_model, buff, 1, cycle=True).astype(np.float64))
            af = _all_frame_score(m, buff, best_j - 2, fr)
            af.append(float(indep_cum[best_j - 3]))
            has_stop = _find_stops_reverse(buff, best_j - 2, m.patterns)
            _permute_by_frame(has_stop, fr)
            int_score = _integerize_scores(af, HI_SCORE, has_stop)
            frame_score = (int_score[frame - 1] if frame > 0
                           else int_score[2 - frame])
            gene_score = 100.0 * best_score / (best_j - 2)
            if orf_is_truncated:
                if frame > 0:
                    orf_start -= 3
                    if best_is_truncated:
                        det_best_pos -= 3
                else:
                    orf_start += 3
                    if best_is_truncated:
                        det_best_pos += 3
            tag = "%04d" % gene_ct if is_tentative else "    "
            row = "%4s %+5d %8d %8d %8d  %7d %7d  %7.2f %5d" % (
                tag, frame, orf_start, det_best_pos, det_k, length,
                best_j + 1, gene_score, frame_score)
            for j6 in range(6):
                row += "  -" if int_score[j6] < 0 else " %2d" % int_score[j6]
            row += " %2d" % int_score[6]
            detail_fp.write(row + "\n")

        if is_tentative:
            if frame > 0:
                engine.add_events_fwd(orf, start_list, pwm_scorer)
            else:
                engine.add_events_rev(orf, start_list, pwm_scorer)

    return gene_ct


class _EventCollector:
    """Engine stand-in that records (orf, start_list, is_fwd) for the
    native C++ event DP (gmg_g3_predict)."""

    def __init__(self):
        self.items = []

    def add_events_fwd(self, orf, start_list, pwm):
        self.items.append((orf, start_list, True))

    def add_events_rev(self, orf, start_list, pwm):
        self.items.append((orf, start_list, False))


def _use_native_g3(models) -> bool:
    # this copy has no native engine: the Python event engine, which the
    # native one mirrors byte for byte, always runs
    return False


_SLOW_PATH_WARNED = False


def _warn_slow_path(reason: str, n: int) -> None:
    """Make the pure-Python fallback cliff visible: the Python event engine
    is orders of magnitude slower than the native path, and silently hitting
    it on a whole genome looks like a hang. Once per process, long
    sequences only."""
    global _SLOW_PATH_WARNED
    if _SLOW_PATH_WARNED or n < 100_000:
        return
    _SLOW_PATH_WARNED = True
    import sys

    print(
        "glimmer_mg_tpu: note: %s; this %.2f Mbp sequence takes the slow "
        "host path (Python ORF scoring%s) instead of the all-native engine"
        % (reason, n / 1e6, "" if _use_native_available() else " + Python DP"),
        file=sys.stderr,
    )


def _use_native_available() -> bool:
    try:
        from .. import native as native_mod

        return native_mod.available()
    except Exception:
        return False


def predict_sequence(models: Models, seq: str, ignore_regions=None,
                     detail_fp=None):
    """Run the full per-sequence pipeline; returns traced genes."""
    import os

    seq_idx = dna.encode(seq)
    n = len(seq_idx)

    if detail_fp is not None:
        print_headings(detail_fp)

    if detail_fp is None and ignore_regions is None and _use_native_g3(models):
        # complete native pipeline: ORF scan + scoring + DP + traceback
        from .. import native as native_mod

        try:
            return native_mod.g3_full(models, seq_idx)
        except native_mod.NativeUnavailable:
            pass

    if not _use_native_g3(models):
        if models.circular:
            _warn_slow_path("circular mode", n)
        else:
            _warn_slow_path("native engine unavailable", n)
    elif detail_fp is not None:
        _warn_slow_path("--detail output requested", n)
    elif ignore_regions is not None:
        _warn_slow_path("ignore regions (-i) requested", n)

    masks = np.array([1, 2, 4, 8], dtype=np.uint8)[seq_idx]

    orf_list = orf_mod.find_orfs(
        masks,
        models.patterns,
        min_gene_len=models.min_gene_len,
        allow_truncated=models.allow_truncated_orfs,
        ignore_regions=ignore_regions,
    )
    pwm_scorer = PwmScorer(models, seq_idx)
    pre = None
    if os.environ.get("GLIMMER_MG_TPU_G3_PRECOMPUTE") != "0":
        # six whole-genome fixed-frame passes replace thousands of per-ORF
        # walks; per-ORF work becomes slicing + a partial-window head fix
        pre = G3Precompute(models, seq_idx)
    if _use_native_g3(models):
        # start scoring stays vectorized-host; event DP + traceback run in
        # the native engine (byte-identical to the Python EventEngine)
        from .. import native as native_mod

        coll = _EventCollector()
        score_orfs(models, seq_idx, orf_list, coll, pwm_scorer,
                   precompute=pre, detail_fp=detail_fp)
        try:
            return native_mod.g3_predict(models, seq_idx, coll.items)
        except native_mod.NativeUnavailable:
            pass  # fall through to the Python DP with collected events
        engine = ev_mod.EventEngine(models, n)
        for orf, sl, is_fwd in coll.items:
            if is_fwd:
                engine.add_events_fwd(orf, sl, pwm_scorer)
            else:
                engine.add_events_rev(orf, sl, pwm_scorer)
    else:
        engine = ev_mod.EventEngine(models, n)
        score_orfs(models, seq_idx, orf_list, engine, pwm_scorer,
                   precompute=pre, detail_fp=detail_fp)
    engine.process_events()
    final = engine.set_final_event()
    return ev_mod.trace_back(final, n)


def run_glimmer3(
    sequences,  # list of (header, seq) pairs
    gene_icm: icm_mod.ICM,
    *,
    gc_frac: float | None = None,
    logodds_fudge: float | None = None,
    use_first_start_codon: bool = False,
    start_codons=None,
    stop_codons=None,
    min_gene_len: int = 75,
    max_olap_bases: int = 50,
    rbs_pwm: features.PWM | None = None,
    feature_models: dict | None = None,
    ignore_regions: list | None = None,
    ignore_score_len: int | None = None,
    allow_truncated_orfs: bool = False,
    detail_fp=None,
):
    """glimmer3 main-mode equivalent. Yields (header, [TracedGene])."""
    patterns = orf_mod.CodonPatterns.make(start_codons, stop_codons)
    if gc_frac is None:
        gc_frac = gc_fraction([s for _, s in sequences])
    indep = icm_mod.build_indep_wo_stops(gc_frac, patterns.stop_codons)
    models = Models(
        gene_icm=gene_icm,
        indep_model=indep,
        patterns=patterns,
        indep_gc_frac=gc_frac,
        min_gene_len=min_gene_len,
        max_olap_bases=max_olap_bases,
        use_first_start_codon=use_first_start_codon,
        allow_truncated_orfs=allow_truncated_orfs,
    )
    # LogOdds_Prior starts at DEFAULT_PRIOR (-1); only -u adds the fudge
    # (float arithmetic, glimmer3.cc:946-953).
    models.logodds_prior = np.float32(-1.0)
    if logodds_fudge is not None:
        models.logodds_prior = np.float32(
            models.logodds_prior + np.float32(logodds_fudge)
        )
    # -q overrides the Poisson default (glimmer3.cc:919-929)
    models.ignore_score_len = (
        ignore_score_len if ignore_score_len is not None
        else set_ignore_score_len(gc_frac, patterns.stop_codons)
    )
    if rbs_pwm is not None:
        models.logodds_pwm = rbs_pwm.make_log_odds_wrt_gc(gc_frac)
        models.user_rbs = True
    if feature_models:
        for key, val in feature_models.items():
            setattr(models, key, val)

    for header, seq in sequences:
        yield header, predict_sequence(models, seq, ignore_regions,
                                       detail_fp=detail_fp)


def score_orflist(models: Models, seq_idx: np.ndarray, orflist_text: str) -> str:
    """glimmer3 -L mode (Score_Orflist, glimmer3.cc:1177): score ORFs at
    given coordinates; returns the .predict text (no header line)."""
    n = len(seq_idx)
    out = []
    for line in orflist_text.splitlines():
        stripped = line.lstrip()
        if not stripped or stripped.startswith("#"):
            continue
        toks = line.split()
        if len(toks) < 4:
            continue
        tag, start, stop, d = toks[0], int(toks[1]), int(toks[2]), int(toks[3])
        if d > 0:
            frame = 1 + (stop % 3)
            length = 1 + stop - start - 3
            if length < 0:
                length += n
            hi = stop - 3
            if hi <= 0:
                hi += n
            pos = (hi - 1 - np.arange(length)) % n
            buff = seq_idx[pos]
        else:
            frame = -((stop - 1) % 3) - 1
            length = 1 + start - stop - 3
            if length < 0:
                length += n
            lo = stop + 2
            if lo >= n:
                lo -= n
            pos = (lo + np.arange(length)) % n
            buff = dna.COMPLEMENT_INDEX[seq_idx[pos]]
        gene_pb = icm_mod.per_base_logprob_vec(models.gene_icm, buff, 1, cycle=True)
        indep_pb = icm_mod.per_base_logprob_vec(models.indep_model, buff, 1, cycle=True)
        score = np.cumsum(gene_pb.astype(np.float64))
        indep = np.cumsum(indep_pb.astype(np.float64))
        m = len(score)
        gene_score = 100.0 * (score[m - 4] - indep[m - 4]) / (m - 3)
        out.append("%-14s %8d %8d %+3d %8.2f" % (tag, start, stop, frame, gene_score))
    return "\n".join(out) + "\n" if out else ""


def score_separate_input(models: Models, sequences) -> str:
    """glimmer3 -M mode (Score_Separate_Input, glimmer3.cc:1555): each input
    sequence is one in-frame ORF (incl. its stop codon)."""
    out = []
    for seq_num, (hdr, seq) in enumerate(sequences):
        seq_idx = dna.encode(seq)
        length = len(seq_idx) - 3  # remove stop codon
        buff = seq_idx[length - 1 :: -1][:length] if length > 0 else seq_idx[:0]
        buff = seq_idx[:length][::-1]
        toks = hdr.split()
        tag = toks[0] if toks else "Seq%04d" % seq_num
        gene_pb = icm_mod.per_base_logprob_vec(models.gene_icm, buff, 1, cycle=True)
        indep_pb = icm_mod.per_base_logprob_vec(models.indep_model, buff, 1, cycle=True)
        score = np.cumsum(gene_pb.astype(np.float64))
        indep = np.cumsum(indep_pb.astype(np.float64))
        m = len(score)
        gene_score = 100.0 * (score[m - 4] - indep[m - 4]) / (m - 3)
        out.append("%-14s %8d %8d %+3d %8.2f" % (tag, 1, m, 1, gene_score))
    return "\n".join(out) + "\n" if out else ""


def format_predict(results) -> str:
    """.predict format (glimmer3.cc:1752: 'orf%05d %8d %8d %+3d %8.2f')."""
    out = []
    for header, genes in results:
        out.append(f">{header}\n")
        for g in genes:
            out.append(
                "orf%05d %8d %8d %+3d %8.2f\n"
                % (g.id, g.start, g.stop, g.frame, g.score)
            )
    return "".join(out)
