# Frozen copy of glimmer_mg_torch/models/features.py at commit ab5a5d3.
"""Feature models: RBS PWM, gene length, start codon, adjacency dists.

Parity targets in the reference:
  PWM_t                 src/Common/gene.cc:165-366
  Length_Dist_t         src/Common/gene.cc:369-649
  Start_Dist_t          src/Common/gene.cc:651-697
  AdjOr_Dist_t          src/Common/gene.cc:700-795
  AdjDist_Dist_t        src/Common/gene.cc:798-925

Default-constructed instances score 0 everywhere (except the start dist,
which defaults to log-odds of {0.60, 0.30, 0.10} vs uniform), matching the
reference globals when no features file is given. ``Make_Log_Odds`` /
features-file construction lives in io/features.py.
"""

from __future__ import annotations

import math

import numpy as np

DEFAULT_START_PROB = (0.60, 0.30, 0.10)
ZERO_EQUIV = 1e-6


class PWM:
    """Position weight matrix (reference PWM_t)."""

    def __init__(self, cols: np.ndarray | None = None):
        # cols: (width, 4) float64 — reference stores double p[4] per column
        self.cols = cols if cols is not None else np.zeros((0, 4), dtype=np.float64)

    @property
    def width(self) -> int:
        return self.cols.shape[0]

    def is_empty(self) -> bool:
        return self.cols.shape[0] == 0

    @classmethod
    def read(cls, path_or_text) -> "PWM":
        """ELPH count format (gene.cc:307): width then 4 rows 'tag v v v …'."""
        if isinstance(path_or_text, str) and "\n" not in path_or_text:
            with open(path_or_text) as fh:
                text = fh.read()
        else:
            text = path_or_text
        toks = text.split()
        width = int(toks[0])
        cols = np.zeros((width, 4), dtype=np.float64)
        pos = 1
        for i in range(4):
            pos += 1  # skip row tag
            for j in range(width):
                cols[j, i] = float(toks[pos])
                pos += 1
        return cls(cols)

    def counts_to_prob(self) -> None:
        """gene.cc:183 Counts_To_Prob with 1e-6 zero-equivalent."""
        for j in range(self.width):
            col = self.cols[j]
            s = col.sum()
            zero_count = int((col == 0.0).sum())
            if s > 0.0:
                col /= s
                nz = col != 0
                col[~nz] = ZERO_EQUIV
                col[nz] /= 1.0 + zero_count * ZERO_EQUIV

    def probs_to_logs(self) -> None:
        if (self.cols <= 0.0).any():
            raise ValueError("log of non-positive value in PWM")
        self.cols = np.log(self.cols)

    def make_log_odds_wrt_gc(self, gc_frac: float) -> "PWM":
        """gene.cc:225: subtract GC-implied background logs. Returns new PWM."""
        if gc_frac <= 0.0:
            raise ValueError("non-positive gc fraction")
        gc_log = math.log(0.5 * gc_frac)
        at_log = math.log(0.5 * (1.0 - gc_frac))
        out = self.cols.copy()
        out[:, 0] -= at_log
        out[:, 1] -= gc_log
        out[:, 2] -= gc_log
        out[:, 3] -= at_log
        return PWM(out)

    def column_scores(self, base_idx: np.ndarray) -> np.ndarray:
        """Scores for bases (…, width) indexing each column; invalid base -> 0
        (handled by callers; our sequences are always 0..3 post-Filter)."""
        return self.cols[np.arange(self.width), base_idx]


class LengthDist:
    """Gene-length log-odds (reference Length_Dist_t). Default: all zeros."""

    MIN_COEFF = 0.85

    def __init__(self):
        self.full = [np.zeros(1)]
        self.trunc = [np.zeros(1)]
        self.trunc2 = [np.zeros(1)]
        self.fragment_lengths = [1000.0]
        self.min_aa_len = 0
        self.full_trunc_merge = [0, 0, 0]

    def is_default(self) -> bool:
        return len(self.full[0]) == 1

    @staticmethod
    def map_length(length: int) -> float:
        return -370.0 + 128.0 * math.log(float(length))

    def choose_frag_dist(self, frag_length: int) -> int:
        m = self.map_length(frag_length)
        errs = [abs(m - f) for f in self.fragment_lengths]
        return int(np.argmin(errs))

    @staticmethod
    def _huge_score(length: int, lo: np.ndarray) -> float:
        n = len(lo)
        if n <= 51:
            return float(lo[-1])
        slope = (lo[n - 1] - lo[n - 1 - 50]) / 50.0
        return float(lo[n - 1] + slope * (length - (n - 1)))

    def score(
        self, length: int, truncated_5p: bool, truncated_3p: bool, frag_length: int
    ) -> float:
        d = self.choose_frag_dist(frag_length)
        if truncated_5p and truncated_3p:
            table = self.trunc2[d]
        elif truncated_5p or truncated_3p:
            table = self.trunc[d]
        else:
            if length >= len(self.full[d]):
                return self._huge_score(length, self.full[d])
            return float(self.full[d][length])

        if length >= len(table):
            return self._huge_score(length, table)
        if length > self.full_trunc_merge[d]:
            return float(table[length])
        # mix with full (gene.cc:470-489)
        x_range = float(self.full_trunc_merge[d] - self.min_aa_len)
        m = (1.0 - self.MIN_COEFF) / x_range
        b = (self.MIN_COEFF * float(self.full_trunc_merge[d]) - float(self.min_aa_len)) / x_range
        coeff = m * length + b
        return coeff * float(table[length]) + (1 - coeff) * float(self.full[d][length])


class StartDist:
    """Start-codon log-odds (reference Start_Dist_t); values stored float32."""

    def __init__(self, start_prob=DEFAULT_START_PROB):
        n = len(DEFAULT_START_PROB)
        self.log_odds = np.array(
            [math.log(p) - math.log(1.0 / n) for p in start_prob], dtype=np.float32
        )

    def score(self, which: int) -> np.float32:
        return self.log_odds[which]

    def make_log_odds(self, gene_starts, non_starts) -> None:
        """gene.cc:656-686: missing gene dist -> defaults, missing non ->
        uniform; log-odds stored float32."""
        n = len(DEFAULT_START_PROB)
        if gene_starts is None or len(gene_starts) == 0:
            gene_starts = np.array(DEFAULT_START_PROB, dtype=np.float32)
        if non_starts is None or len(non_starts) == 0:
            non_starts = np.full(n, np.float32(1.0 / n))
        self.log_odds = np.array(
            [math.log(float(g)) - math.log(float(nn))
             for g, nn in zip(gene_starts, non_starts)],
            dtype=np.float32,
        )


class AdjOrDist:
    """Adjacent-orientation log-odds (reference AdjOr_Dist_t), float32."""

    def __init__(self):
        self.ff = np.float32(0.0)
        self.fr = np.float32(0.0)
        self.rf = np.float32(0.0)
        self.rr = np.float32(0.0)

    def score_events(self, e1: int, e2: int) -> np.float32:
        """e1/e2 are Event type codes (see engine.events). gene.cc:733-770."""
        from ..engine.events import FWD_STOP, REV_START, FWD_START, REV_STOP

        if e1 == FWD_STOP:
            return self.ff if e2 == FWD_START else self.fr
        if e1 == REV_START:
            return self.rf if e2 == FWD_START else self.rr
        return np.float32(0.0)  # INITIAL / TERMINAL

    def make_log_odds(self, gene_adjor, non_adjor) -> None:
        """gene.cc:798-830: no info -> zeros; missing non -> uniform."""
        if gene_adjor is None or len(gene_adjor) < 4:
            self.ff = self.fr = self.rf = self.rr = np.float32(0.0)
            return
        if non_adjor is None or len(non_adjor) < 4:
            non_adjor = np.full(4, np.float32(0.25))
        lo = [
            np.float32(math.log(float(g)) - math.log(float(nn)))
            for g, nn in zip(gene_adjor, non_adjor)
        ]
        self.ff, self.fr, self.rf, self.rr = lo


class AdjDistDist:
    """Adjacent-distance log-odds (reference AdjDist_Dist_t), float32 tables."""

    def __init__(self):
        self.max_overlap = 0
        self.ff = np.zeros(1, dtype=np.float32)
        self.fr = np.zeros(1, dtype=np.float32)
        self.rf = np.zeros(1, dtype=np.float32)

    def _look(self, table: np.ndarray, length: int) -> np.float32:
        idx = length + self.max_overlap
        if idx >= len(table) or idx < 0:
            # reference uses unsigned index: negative wraps huge -> .back()
            return table[-1]
        return table[idx]

    def score_events(self, e1: int, e2: int, length: int) -> np.float32:
        from ..engine.events import FWD_STOP, REV_START, FWD_START, REV_STOP

        if e1 == FWD_STOP:
            return self._look(self.ff if e2 == FWD_START else self.fr, length)
        if e1 == REV_START:
            # note: reference uses Fwd_Fwd for REV_START->REV_STOP (gene.cc:881)
            return self._look(self.rf if e2 == FWD_START else self.ff, length)
        return np.float32(0.0)

    def make_log_odds(self, key: str, gene_dist, non_dist) -> None:
        """gene.cc:898-925 Make_Log_Odds_Fwd_* for key in {ff, fr, rf}."""
        if gene_dist is None or len(gene_dist) == 0 or non_dist is None or len(non_dist) == 0:
            setattr(self, key, np.zeros(1, dtype=np.float32))
            return
        lo = np.log(np.asarray(gene_dist, np.float32).astype(np.float64)) - np.log(
            np.asarray(non_dist, np.float32).astype(np.float64)
        )
        setattr(self, key, lo.astype(np.float32))
