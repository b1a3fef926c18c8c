# Frozen copy of glimmer_mg_torch/engine/events.py at commit ab5a5d3.
"""Gene event-graph dynamic program.

Reimplements the reference's event chain construction and DP exactly:
  Add_Events_Fwd / Add_Events_Rev   glimmer_base.cc:43-263
  Add_PWM_Score                     glimmer_base.cc:267-295
  Process_Events                    glimmer_base.cc:1530-1606
  Process_Fwd_Start_Rev_Stop_Event  glimmer_base.cc:1609-1703
  Process_Initial_Event             glimmer_base.cc:1706-1723
  Process_Fwd_Stop_Rev_Start_Event  glimmer_base.cc:1726-1896
  Disqualify / Requalify            glimmer_base.cc:437-458 / 2463-2480
  Set_Final_Event                   glimmer_base.cc:2536-2561
  Trace_Back                        glimmer3.cc:1631-1759

Precision notes: event scores are C doubles, but Process_Fwd_Start_Rev_Stop
compares candidates in *float32* (`float this_score, max_score`), and the
adjacency model scores are float32 — all mirrored here with np.float32.

This Python implementation is the exact ORACLE for the event semantics:
whole-genome (glimmer3) prediction and the Python fallback path run it
directly, and the production native C++ engine (native/engine.cpp) mirrors
it operation-for-operation (validated in tests/test_native.py). The
glimmer-mg entry points feed either engine device-precomputed 6-frame LLR
arrays (ops/icm_score.mg_six_frame_batch) or native-walk equivalents.
"""

from __future__ import annotations

import numpy as np

# Event type codes (reference Event_t enum order, gene.hh:59)
INITIAL, FWD_START, FWD_STOP, REV_START, REV_STOP, TERMINAL = range(6)

F32 = np.float32


class Event:
    __slots__ = (
        "e_type", "id", "pos", "frame", "score", "pwm_score", "pwm_sep",
        "is_first_start", "truncated", "disqualified", "errors",
        "frame_pred", "best_pred",
    )

    def __init__(self):
        self.e_type = INITIAL
        self.id = 0
        self.pos = 0
        self.frame = 0
        self.score = 0.0
        self.pwm_score = 0.0
        self.pwm_sep = 0
        self.is_first_start = False
        self.truncated = False
        self.disqualified = False
        self.errors = ()
        self.frame_pred = None
        self.best_pred = None


def frame_to_sub(f: int) -> int:
    return f - 1 if f > 0 else 2 - f


def add_pwm_score(ev: Event) -> None:
    """glimmer_base.cc:267-295 (LO_SEP=4, HI_SEP=10, HI_TAIL=6)."""
    LO_SEP, HI_SEP, HI_TAIL = 4, 10, 6
    if ev.pwm_score < 0.0:
        return
    if ev.pwm_sep < LO_SEP:
        coeff = float(ev.pwm_sep) / LO_SEP
    elif ev.pwm_sep <= HI_SEP:
        coeff = 1.0
    elif ev.pwm_sep < HI_SEP + HI_TAIL:
        coeff = float(HI_SEP + HI_TAIL - ev.pwm_sep) / HI_TAIL
    else:
        coeff = 0.0
    if 0.0 < coeff:
        ev.score += coeff * ev.pwm_score


class EventEngine:
    """Per-sequence event chains + DP state (the reference's globals)."""

    def __init__(self, models, sequence_len: int):
        # models: engine.glimmer3.Models (feature dists + thresholds)
        self.m = models
        self.sequence_len = sequence_len
        self.first_event = Event()
        self.first_event.e_type = INITIAL
        self.last_event = [self.first_event] * 6
        self.best_event = [self.first_event] * 6
        self.final_event = Event()
        self.final_event.e_type = TERMINAL
        self.id_counter = 0

    # -- event construction ------------------------------------------------

    def add_events_fwd(self, orf, start_list, pwm_scorer) -> None:
        """glimmer_base.cc:43-150. start_list: list of Start records."""
        m = self.m
        fr = orf.frame
        sub = fr - 1
        start_event_map: dict[int, Event] = {}
        for s in start_list:
            if 1 + s.j < m.min_gene_len:
                continue
            ne = Event()
            ne.e_type = FWD_START
            ne.pos = s.pos + 2
            ne.frame = fr
            ne.score = s.score + float(m.logodds_prior)
            ne.pwm_score, ne.pwm_sep = pwm_scorer.fwd_start(s.pos)
            add_pwm_score(ne)
            if s.which >= 0:
                ne.score += float(m.logodds_start.score(s.which))
            ne.score += m.logodds_length.score(
                (1 + s.j) // 3,
                s.truncated,
                orf.stop_position > self.sequence_len - 2,
                self.sequence_len // 3,
            )
            ne.is_first_start = s.first
            ne.truncated = s.truncated
            ne.errors = tuple(s.errors)
            if ne.score > m.event_threshold:
                old = start_event_map.get(ne.pos)
                if old is None or ne.score > old.score:
                    start_event_map[ne.pos] = ne

        error_id_map: dict[tuple, int] = {}
        for pos in sorted(start_event_map):
            ne = start_event_map[pos]
            ne.frame_pred = self.last_event[sub]
            self.last_event[sub] = ne
            if ne.errors not in error_id_map:
                self.id_counter += 1
                error_id_map[ne.errors] = self.id_counter
            ne.id = error_id_map[ne.errors]

        if start_event_map:
            for errors in sorted(error_id_map, key=_error_key):
                ne = Event()
                ne.e_type = FWD_STOP
                ne.id = error_id_map[errors]
                ne.pos = orf.stop_position + 2
                ne.frame = fr
                ne.score = 0.0
                ne.errors = errors
                ne.frame_pred = self.last_event[sub]
                self.last_event[sub] = ne

    def add_events_rev(self, orf, start_list, pwm_scorer) -> None:
        """glimmer_base.cc:153-263. Note stop events precede starts here."""
        m = self.m
        fr = orf.frame
        sub = 2 - fr
        start_event_map: dict[int, Event] = {}
        for s in start_list:
            if 1 + s.j < m.min_gene_len:
                continue
            ne = Event()
            ne.e_type = REV_START
            ne.pos = s.pos
            ne.frame = fr
            ne.score = s.score + float(m.logodds_prior)
            ne.pwm_score, ne.pwm_sep = pwm_scorer.rev_start(s.pos)
            add_pwm_score(ne)
            if s.which >= 0:
                ne.score += float(m.logodds_start.score(s.which))
            ne.score += m.logodds_length.score(
                (1 + s.j) // 3,
                s.truncated,
                orf.stop_position < 1,
                self.sequence_len // 3,
            )
            ne.is_first_start = s.first
            ne.truncated = s.truncated
            ne.errors = tuple(s.errors)
            if ne.score > m.event_threshold:
                old = start_event_map.get(ne.pos)
                if old is None or ne.score > old.score:
                    start_event_map[ne.pos] = ne

        error_id_map: dict[tuple, int] = {}
        for pos in sorted(start_event_map):
            ne = start_event_map[pos]
            if ne.errors not in error_id_map:
                self.id_counter += 1
                error_id_map[ne.errors] = self.id_counter
            ne.id = error_id_map[ne.errors]

        for errors in sorted(error_id_map, key=_error_key):
            ne = Event()
            ne.e_type = REV_STOP
            ne.id = error_id_map[errors]
            ne.pos = orf.stop_position + 2
            ne.frame = fr
            ne.score = 0.0
            ne.errors = errors
            ne.frame_pred = self.last_event[sub]
            self.last_event[sub] = ne

        for pos in sorted(start_event_map):
            ne = start_event_map[pos]
            ne.frame_pred = self.last_event[sub]
            self.last_event[sub] = ne

    # -- the DP ------------------------------------------------------------

    def _adj_scores(self, pred: Event, ep: Event):
        """float32 AdjOr + AdjDist candidate expression pieces."""
        m = self.m
        distance = ep.pos - pred.pos - 3
        return (
            m.logodds_adj_or.score_events(pred.e_type, ep.e_type),
            m.logodds_adj_dist.score_events(pred.e_type, ep.e_type, distance),
        )

    def process_events(self) -> None:
        ep_list: list[Event] = []
        initial = None
        for i in range(6):
            min_pos = 0
            p = self.last_event[i]
            while p is not None and p.e_type != INITIAL:
                ep_list.append(p)
                min_pos = min(min_pos, p.pos - 1)
                p = p.frame_pred
            if p is None:
                raise RuntimeError("missing initial event")
            p.pos = min(min_pos, p.pos)
            initial = p
        ep_list.append(initial)

        # std::sort with Event_Pos_Cmp — use the faithful libstdc++
        # introsort so equal-pos orderings match the reference exactly.
        from ..utils.stdsort import std_sort

        std_sort(ep_list, lambda a, b: a.pos < b.pos)

        if getattr(self.m, "circular", False):
            reference_pos = self._find_uncovered_position(ep_list)
            if reference_pos > 0:
                self._shift_events(ep_list, reference_pos)

        for ev in ep_list:
            if ev.e_type == INITIAL:
                self._process_initial(ev)
            elif ev.e_type in (FWD_START, REV_STOP):
                self._process_fwd_start_rev_stop(ev)
            else:
                self._process_fwd_stop_rev_start(ev)

    def _find_uncovered_position(self, ep_list) -> int:
        """Find_Uncovered_Position (glimmer_base.cc:556-634)."""
        n = len(ep_list)
        if n <= 1:
            return 0
        first_pos = ep_list[1].pos - 3
        last_pos = ep_list[n - 1].pos - self.sequence_len
        if last_pos <= first_pos:
            return 0
        cover_ct = 0
        zero_pos = ep_list[n - 1].pos
        for i in range(1, n):
            t = ep_list[i].e_type
            if t == FWD_START:
                if ep_list[i].is_first_start:
                    cover_ct += 1
                    if cover_ct == 1 and 3 <= ep_list[i].pos - zero_pos:
                        return zero_pos
            elif t == FWD_STOP:
                cover_ct -= 1
                if cover_ct == 0:
                    zero_pos = ep_list[i].pos
            elif t == REV_START:
                if ep_list[i].is_first_start:
                    cover_ct -= 1
                    if cover_ct == 0:
                        zero_pos = ep_list[i].pos
            elif t == REV_STOP:
                cover_ct += 1
                if cover_ct == 1 and 3 <= ep_list[i].pos - zero_pos:
                    return zero_pos
            else:
                raise RuntimeError(f"unexpected event type {t}")
        return 0

    def _shift_events(self, ep_list, reference_pos: int) -> None:
        """Shift_Events (glimmer_base.cc:2711-2760): rotate events before
        reference_pos to the back (+Sequence_Len) and relink frame chains."""
        from ..utils.stdsort import std_sort

        n = len(ep_list)
        if n <= 1:
            return
        frame_last = list(self.last_event)
        q = n - 1
        while q > 0 and reference_pos < ep_list[q].pos:
            f = frame_to_sub(ep_list[q].frame)
            frame_last[f] = ep_list[q]
            q -= 1
        for f in range(6):
            if reference_pos < frame_last[f].pos:
                frame_last[f].frame_pred = ep_list[0]
            else:
                self.last_event[f] = ep_list[0]
        for i in range(1, q + 1):
            ev = ep_list[i]
            ev.pos += self.sequence_len
            # Set_Frame_From_Pos (glimmer_base.cc:2916)
            fabs = 1 + (ev.pos % 3)
            ev.frame = fabs if ev.frame > 0 else -fabs
            f = frame_to_sub(ev.frame)
            ev.frame_pred = self.last_event[f]
            self.last_event[f] = ev
        std_sort(ep_list, lambda a, b: a.pos < b.pos)

    def _process_initial(self, ev: Event) -> None:
        for i in range(6):
            self.best_event[i] = self.last_event[i] = ev
        ev.pos = 0
        ev.score = 0.0
        ev.frame_pred = ev.best_pred = None

    def _process_fwd_start_rev_stop(self, ev: Event) -> None:
        """glimmer_base.cc:1609-1703 — float32 candidate comparisons."""
        f = frame_to_sub(ev.frame)

        max_event = self.best_event[0]
        if max_event.e_type == INITIAL:
            max_score = F32(max_event.score)
        else:
            o, d = self._adj_scores(max_event, ev)
            max_score = F32(max_event.score + float(o) + float(d))

        for i in range(6):
            p = self.last_event[i]
            while p is not self.best_event[i]:
                if p.e_type in (FWD_STOP, REV_START) and p.score > 0:
                    o, d = self._adj_scores(p, ev)
                    this_score = F32(p.score + float(o) + float(d))
                    if this_score > max_score:
                        max_score = this_score
                        max_event = p
                p = p.frame_pred

            be = self.best_event[i]
            if be.e_type == REV_START:
                q = be
                while q.e_type == REV_START:
                    o, d = self._adj_scores(q, ev)
                    this_score = F32(q.score + float(o) + float(d))
                    if this_score > max_score:
                        max_score = this_score
                        max_event = q
                    q = q.frame_pred
            elif be.e_type == FWD_STOP:
                o, d = self._adj_scores(be, ev)
                this_score = F32(be.score + float(o) + float(d))
                if this_score > max_score:
                    max_score = this_score
                    max_event = be
            else:  # INITIAL
                this_score = F32(be.score)
                if this_score > max_score:
                    max_score = this_score
                    max_event = be

        ev.best_pred = max_event
        ev.score += float(max_score)
        ev.frame_pred = self.last_event[f]
        self.last_event[f] = ev

    def _process_fwd_stop_rev_start(self, ev: Event) -> None:
        """glimmer_base.cc:1726-1896."""
        m = self.m
        f = frame_to_sub(ev.frame)

        if ev.e_type == FWD_STOP:
            mx = -np.inf
            best_p = None
            p = self.last_event[f]
            while p.e_type != INITIAL:
                if p.id == ev.id and p.score > mx:
                    mx = p.score
                    best_p = p
                p = p.frame_pred
            ev.best_pred = best_p
            ev.score = mx
            # p ends at the INITIAL event (used by Disqualify below)
        else:  # REV_START: find its REV_STOP
            p = self.last_event[f]
            while p is not None and (p.e_type == REV_START or p.id != ev.id):
                p = p.frame_pred
            if p is None or p.e_type != REV_STOP:
                raise RuntimeError(f"no reverse stop for reverse start at {ev.pos}")
            ev.best_pred = p
            ev.score += p.score

        if self.best_event[f].score < ev.score:  # adj_score_buf == 0.0
            cutoff = 3 + ev.pos - m.max_olap_bases
            _disqualify(p, cutoff)

            if self.best_event[f].score < ev.score:
                self.best_event[f] = ev

            for i in range(6):
                p = self.last_event[i]
                while p is not None and 3 + ev.pos - p.pos <= m.max_olap_bases:
                    if not p.disqualified and p.e_type in (FWD_START, REV_STOP):
                        score_needed = 0.0 if p.best_pred is None else p.best_pred.score
                        if score_needed < ev.score:
                            # overlap error check (no-op without indels/subs)
                            overlap_error = False
                            for err in ev.errors:
                                if p.pos - 2 <= err.pos:
                                    overlap_error = True
                            for err in p.errors:
                                if err.pos <= ev.pos:
                                    overlap_error = True
                            if not overlap_error:
                                diff = ev.score - p.best_pred.score  # adj == 0.0
                                if p.best_pred is None or p.best_pred.e_type == INITIAL:
                                    old_adj = F32(0)
                                else:
                                    o, d = self._adj_scores_pair(p.best_pred, p)
                                    old_adj = F32(o + d)
                                o, d = self._adj_scores_pair(ev, p)
                                new_adj = F32(o + d)
                                diff += float(F32(new_adj - old_adj))
                                if diff > 0:
                                    p.score += diff
                                    p.best_pred = ev
                                    q = self.last_event[i]
                                    while q is not p:
                                        if q.best_pred is p:
                                            q.score += diff
                                        q = q.frame_pred
                    p = p.frame_pred

            _requalify(p, cutoff)

        ev.frame_pred = self.last_event[f]
        self.last_event[f] = ev

    def _adj_scores_pair(self, pred: Event, succ: Event):
        m = self.m
        distance = succ.pos - pred.pos - 3
        return (
            m.logodds_adj_or.score_events(pred.e_type, succ.e_type),
            m.logodds_adj_dist.score_events(pred.e_type, succ.e_type, distance),
        )

    def set_final_event(self) -> Event:
        fe = self.final_event
        fe.pos = self.sequence_len
        fe.score = self.best_event[0].score
        fe.best_pred = self.best_event[0]
        for i in range(1, 6):
            if self.best_event[i].score >= fe.score:
                fe.score = self.best_event[i].score
                fe.best_pred = self.best_event[i]
        return fe


def _error_key(errors: tuple) -> tuple:
    """std::map ordering of vector<Error_t> via vec_error_cmp
    (glimmer_base.hh:96-117): by size, then lexicographic (pos, type)."""
    return (len(errors),) + tuple((e.pos, e.type) for e in errors)


def _disqualify(p: Event, cutoff: int) -> None:
    if p is None:
        return
    q = p.best_pred
    while q is not None and cutoff <= q.pos:
        q.disqualified = True
        q = q.best_pred


def _requalify(p: Event, cutoff: int) -> None:
    if p is None:
        return
    q = p.best_pred
    while q is not None and cutoff <= q.pos:
        q.disqualified = False
        q = q.best_pred


# -- traceback --------------------------------------------------------------


class TracedGene:
    __slots__ = ("id", "start", "stop", "frame", "score", "errors", "truncated")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


def trace_back(final_event: Event, sequence_len: int, circular: bool = False):
    """glimmer3.cc:1631-1759. Returns genes in output order with final
    1-based [start, stop] coordinates and per-gene scores."""
    TRUNCATED_START_FLAG = 0x02

    genes = []
    cur = dict(stop_position=0, frame=0, gene_len=0, score=0.0, id=0,
               errors=(), status=0)
    prev_score = 0.0
    rev_start = 0
    rev_errors = ()
    p = final_event.best_pred
    while p.e_type != INITIAL:
        if p.e_type == FWD_START:
            j = cur["stop_position"]
            cur["gene_len"] = 2 + j - p.pos
            cur["score"] = p.score - p.best_pred.score
            cur["id"] = p.id
            cur["errors"] = p.errors
            if p.truncated:
                cur["status"] |= TRUNCATED_START_FLAG
            genes.append(dict(cur))
            cur["status"] = 0
        elif p.e_type == FWD_STOP:
            cur["stop_position"] = p.pos - 2
            cur["frame"] = 1 + (p.pos % 3)
        elif p.e_type == REV_START:
            rev_start = p.pos
            prev_score = p.score
            rev_errors = p.errors
            if p.truncated:
                cur["status"] |= TRUNCATED_START_FLAG
        elif p.e_type == REV_STOP:
            cur["stop_position"] = p.pos - 2
            cur["frame"] = -(1 + (p.pos % 3))
            cur["gene_len"] = rev_start - p.pos
            cur["score"] = prev_score - p.score
            cur["id"] = p.id
            cur["errors"] = rev_errors
            genes.append(dict(cur))
            cur["status"] = 0
        else:
            raise RuntimeError(f"bad event type {p.e_type}")
        p = p.best_pred

    # frame fixup by final stop position (glimmer3.cc:1692-1707)
    def position_to_frame(pp: int) -> int:
        if pp >= 0:
            return 1 + ((pp + 2) % 3)
        return 3 - ((-pp) % 3)

    out = []
    for g in genes:
        j = g["stop_position"]
        fabs = position_to_frame(j)
        frame = fabs if g["frame"] > 0 else -fabs
        if frame > 0:
            stop = g["stop_position"] + 2
            start = stop - g["gene_len"] - 2
            if g["status"] & TRUNCATED_START_FLAG:
                start -= 3
        else:
            stop = g["stop_position"]
            start = stop + g["gene_len"] + 2
            if g["status"] & TRUNCATED_START_FLAG:
                start += 3
        out.append(
            TracedGene(
                id=g["id"], start=start, stop=stop, frame=frame,
                score=g["score"], errors=g["errors"],
                truncated=bool(g["status"] & TRUNCATED_START_FLAG),
            )
        )
    # output order: reversed traceback order (glimmer3.cc:1712)
    return out[::-1]
