"""K3's plain version, ``ops.event_dp.event_dp_traceback``, against the JAX
package's ``_event_dp_batched`` + ``_traceback_batched``, on the CPU.

Seeded reads go through the port's frontend (as ``predict_batch_device``
runs it, on the CPU); the same event rows, adjacency tables and event
counts, as numpy arrays, go to the JAX functions (under ``jax.jit``, the
f32 carry traced without x64 as the JAX package's device path does) and
to the port. Cases: error-free, substitution mode and substitution mode
with a quality file, each with the f64 and the f32 carry; a batch whose
scores and adjacency tables are rounded to a grid of 0.5, so that
candidates tie; event-dense substitution-mode batches (every start
candidate an event: reads at MAX_EVENTS; and with the DP's max_olap
widened to 300, so that in-range events fall outside the 48-row window
and raise ``wovf``: the overlap-dense reads of the error-free batch stay
within the window even so); a batch cut to E = 40 events (W = E < 48).
``bp``, ``best``, ``wovf``, ``cnt`` and the integer gene records must be
equal; ``score`` and ``g_score`` equal to
the last bit (JAX reads by one-hot sums, which give the same bits up to
the sign of a zero, which ``==`` ignores). Each read run alone (B = 1)
gives the rows it has in the batch, and the rows at e >= ne are typ == 0:
K3's per-read loop bound. The wrapper takes the twin on CPU tensors
and rejects other devices; its outputs (``event_dp_cuda.outputs``) are
carved from one buffer a dtype, aligned and disjoint, in the twin's
shapes and dtypes.
"""

import jax
import numpy as np
import pytest
import torch

from glimmer_mg_tpu.ops import device_predict as jdp
from glimmer_mg_torch.ops import (device_predict as tdp, event_dp,
                                  event_dp_cuda, frontend, icm_score)

from tests._torch_common import (  # noqa: F401  (fixtures)
    batch_inputs, class_map, long_reads, one_torch_thread,
    overlap_dense_reads, planted_stop_reads, quality_map, random_reads,
    trained_models,
)

OUT = ("score bp best wovf g_id g_stop g_len g_sign g_trunc g_score g_epos "
       "g_etyp cnt").split()
FLOATS = ("score", "g_score")


ADJ_TABLES = ("adj_or", "adj_dist", "adj_dist_len")


def event_rows(batch, *, f64=True, subs=False, quals=None, thresh=None,
               device="cpu"):
    """The port's frontend rows of a padded batch (models_list, reads,
    lengths, groups), made as ``predict_batch_device`` makes them, with
    the six-frame twin: (ev, the bank's adjacency tables, groups, consts,
    ne) on ``device``, the arguments of the K3 wrapper. ``thresh``
    replaces the event and start thresholds (every candidate an event)."""
    models_list, seqs, lengths, groups = batch
    L0 = seqs.shape[1]
    pad = (-L0) % 3
    bank = tdp.build_bank(models_list, L0)
    if thresh is not None:
        bank.event_threshold = bank.start_threshold = thresh
    dev = tdp.bank_to_device(bank, device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    reads, lens, grp = t(seqs), t(lengths), t(groups)
    g6, i6 = icm_score.mg_six_frame_batch(
        dev["gene_mip"], dev["gene_probs"], dev["indep_mip"],
        dev["indep_probs"], reads, lens, grp, model_len=bank.model_len,
        depth=bank.depth)
    consts = dict(min_gene_len=bank.min_gene_len, max_olap=bank.max_olap,
                  event_threshold=bank.event_threshold,
                  start_threshold=bank.start_threshold,
                  ws=bank.ribosome_window, W=bank.pwm_w,
                  fdt=torch.float64 if f64 else torch.float32, subs=subs)
    q = None
    if subs and quals is not None:
        q = torch.nn.functional.pad(t(quals), (0, pad), value=255)
    F = torch.nn.functional
    ev, n_events = frontend.frontend(
        F.pad(reads, (0, pad)), lens, grp, F.pad(g6, (0, pad)),
        F.pad(i6, (0, pad)), dev, L0 + pad, consts, tdp.MAX_EVENTS, quals=q)
    ne = torch.clamp(n_events, max=tdp.MAX_EVENTS)
    return ev, {k: dev[k] for k in ADJ_TABLES}, grp, consts, ne


def twin(rows):
    """The plain version on wrapper arguments (its per-read tables made
    by ``_prefetch_adj``, as the wrapper's CPU route does)."""
    ev, tables, groups, consts, ne = rows
    return event_dp.event_dp_traceback(
        ev, event_dp._prefetch_adj(tables, groups), consts, ne)


def quals_of(reads, seqs, seed):
    """uint8 qualities of ``quality_map`` (255 in rows without one)."""
    qm = quality_map(reads, seed)
    q = np.full(seqs.shape, 255, np.uint8)
    for r, (h, _s) in enumerate(reads):
        if h in qm:
            q[r, :len(qm[h])] = np.minimum(qm[h], 254)
    return q


def rounded(ev, tables, grid=0.5):
    """Scores and adjacency tables on a grid of ``grid``: ties."""
    r = lambda x: torch.round(x / grid) * grid  # noqa: E731
    return (dict(ev, score=r(ev["score"])),
            dict(tables, adj_or=r(tables["adj_or"]),
                 adj_dist=r(tables["adj_dist"])))


def narrowed(ev, ne, E):
    """The first E event columns (as MAX_EVENTS = E would give)."""
    return ({k: v[:, :E].contiguous() for k, v in ev.items()},
            torch.clamp(ne, max=E))


_JAX_FNS = {}


def jax_dp(rows, f64):
    """JAX _event_dp_batched then _traceback_batched on the same arrays
    (the per-read tables of ``_prefetch_adj``), jitted (one compile per
    shape, max_olap and carry); numpy outputs."""
    ev, tables, groups, consts, ne = rows
    adj = event_dp._prefetch_adj(tables, groups)
    D, mo = adj["D"], consts["max_olap"]
    key = (D, mo, f64)
    if key not in _JAX_FNS:
        def run(ev_j, adj_j, ne_j):
            a = dict(adj_j, tab0=adj_j["tab"][:, 0], tab1=adj_j["tab"][:, 1],
                     tab2=adj_j["tab"][:, 2], D=D)
            c = {"max_olap": mo}
            score, bp, best, wovf = jdp._event_dp_batched(ev_j, a, c, ne_j)
            genes = jdp._traceback_batched(ev_j, score, bp, best, ne_j)
            return (score, bp, best, wovf, *genes)
        _JAX_FNS[key] = jax.jit(run)
    np_ev = {k: v.numpy() for k, v in ev.items()}
    np_adj = {k: adj[k].numpy() for k in ("ao", "dl", "tab", "satv")}
    with jax.enable_x64(f64):
        out = _JAX_FNS[key](np_ev, np_adj, ne.numpy())
        return [np.asarray(x) for x in out]


def assert_same(want, got, names=OUT):
    """Integer outputs equal; float outputs equal value for value (NaN
    equal to NaN)."""
    for name, a, b in zip(names, want, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        if name in FLOATS:
            assert a.dtype == b.dtype, name
            same = (a == b) | (np.isnan(a) & np.isnan(b))
            assert same.all(), (name, int((~same).sum()))
        else:
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), name


@pytest.fixture(scope="module")
def chunks(trained_models, one_torch_thread):
    """Two padded batches: error-free (random, overlap-dense and long
    reads, 2,112 bp) and substitution mode (reads with planted stops and
    long reads, with a quality map)."""
    gd, classes = trained_models
    ef = (random_reads(17, 10) + overlap_dense_reads(41, 18)
          + long_reads(29, 4))
    sb = planted_stop_reads(62, 20) + long_reads(31, 4)
    out = {}
    for name, reads in (("ef", ef), ("subs", sb)):
        cmap = class_map(reads, classes, pair_every=3)
        batch = batch_inputs(reads, cmap, gd, l_pad=2112, b_pad=len(reads))
        out[name] = (batch, quals_of(reads, batch[1], 62))
    return out


CASES = {
    # name: (chunk, frontend options, transform)
    "error_free": ("ef", {}, None),
    "subs": ("subs", {"subs": True}, None),
    "subs_quality_file": ("subs", {"subs": True, "quals": True}, None),
    "ties": ("ef", {}, "ties"),
    "subs_dense_wovf": ("subs", {"subs": True, "thresh": -1e9}, "wide_olap"),
    "subs_dense_max_events": ("subs", {"subs": True, "thresh": -1e9}, None),
    "narrow_E40": ("ef", {"thresh": -1e9}, "narrow"),
}


def case_rows(chunks, case, f64, device="cpu"):
    """The wrapper's arguments for one of CASES."""
    chunk, opts, how = CASES[case]
    batch, q = chunks[chunk]
    opts = dict(opts)
    if opts.pop("quals", False):
        opts["quals"] = q
    ev, tables, groups, consts, ne = event_rows(batch, f64=f64,
                                                device=device, **opts)
    if how == "ties":
        ev, tables = rounded(ev, tables)
    elif how == "wide_olap":
        consts = dict(consts, max_olap=300)
    elif how == "narrow":
        ev, ne = narrowed(ev, ne, 40)
    return ev, tables, groups, consts, ne


@pytest.fixture(scope="module")
def rows_cache(chunks):
    cache = {}

    def get(case, f64):
        if (case, f64) not in cache:
            cache[case, f64] = case_rows(chunks, case, f64)
        return cache[case, f64]
    return get


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_jax(rows_cache, case, f64):
    rows = rows_cache(case, f64)
    ev, ne = rows[0], rows[4]
    want = jax_dp(rows, f64)
    got = twin(rows)
    assert_same(want, [x.numpy() for x in got])
    assert got[0].dtype == (torch.float64 if f64 else torch.float32)
    assert event_dp.last_syncs > 0
    cnt, wovf = got[12], got[3]
    assert cnt.sum() > 10  # genes were called
    if case == "subs_dense_wovf":
        assert wovf.sum() > 0
    if case == "subs_dense_max_events":
        assert (ne == tdp.MAX_EVENTS).sum() > 0
        assert (got[11] >= 0).sum() > 0  # substitution records
    if case == "narrow_E40":
        assert ev["pos"].shape[1] == 40 and (ne == 40).sum() > 0


@pytest.mark.parametrize("case", ["error_free", "subs_quality_file",
                                  "subs_dense_max_events"])
def test_each_read_alone_gives_its_batch_rows(rows_cache, case):
    """K3's loop bound: a read's steps stop at its own ne, where the
    twin's batch-wide loop runs on over typ == 0 padding rows. (The
    widened max_olap of subs_dense_wovf breaks min_gene_len > max_olap +
    3, so its predecessor graphs may be cyclic and a traceback may run to
    the batch's bound: K3 reads that bound too.)"""
    ev, tables, groups, consts, ne = rows_cache(case, True)
    E = ev["pos"].shape[1]
    padding = torch.arange(E)[None, :] >= ne[:, None]
    assert (ev["typ"][padding] == 0).all()
    assert (ev["typ"][~padding] != 0).all()
    batch = twin((ev, tables, groups, consts, ne))
    order = torch.argsort(ne, descending=True).tolist()
    for b in order[:3] + order[len(order) // 2::6]:
        one = twin(({k: v[b:b + 1] for k, v in ev.items()}, tables,
                    groups[b:b + 1], consts, ne[b:b + 1]))
        assert_same([x[b:b + 1].numpy() for x in batch],
                    [x.numpy() for x in one])


def test_wrapper_takes_twin_on_cpu(rows_cache):
    rows = rows_cache("subs", True)
    event_dp_cuda.reset_launches()
    got = event_dp_cuda.event_dp_traceback(*rows)
    assert_same([x.numpy() for x in twin(rows)], [x.numpy() for x in got])
    assert event_dp_cuda.launches == 0


def test_wrapper_rejects_other_devices(rows_cache):
    ev, tables, groups, consts, ne = rows_cache("error_free", True)
    meta = {k: v.to("meta") for k, v in ev.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        event_dp_cuda.event_dp_traceback(meta, tables, groups, consts, ne)


def test_predict_batch_device_routes_through_wrapper(chunks, monkeypatch):
    """predict_batch_device calls the wrapper (the twin on the CPU) and
    returns its gene records."""
    calls = []
    wrapped = event_dp_cuda.event_dp_traceback

    def spy(*a, **k):
        out = wrapped(*a, **k)
        calls.append(out)
        return out

    monkeypatch.setattr(event_dp_cuda, "event_dp_traceback", spy)
    (models_list, seqs, lengths, groups), _q = chunks["ef"]
    bank = tdp.build_bank(models_list, seqs.shape[1])
    dev = tdp.bank_to_device(bank, "cpu")
    t = torch.from_numpy
    g6, i6 = icm_score.mg_six_frame_batch(
        dev["gene_mip"], dev["gene_probs"], dev["indep_mip"],
        dev["indep_probs"], t(seqs), t(lengths), t(groups),
        model_len=bank.model_len, depth=bank.depth)
    out = tdp.predict_batch_device(bank, dev, t(seqs), t(lengths),
                                   t(groups), g6, i6)
    assert len(calls) == 1
    assert_same([x.numpy() for x in calls[0][4:]], out[:9], OUT[4:])


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("case", ["error_free", "narrow_E40"])
def test_wrapper_outputs_carved_from_one_buffer_a_dtype(rows_cache, case,
                                                        f64):
    """The wrapper's outputs on device="cpu": the twin's shapes and dtypes,
    contiguous, each 16-byte aligned, no two overlapping, one storage a
    dtype."""
    rows = rows_cache(case, f64)
    want = twin(rows)
    B, E = rows[0]["pos"].shape
    got = event_dp_cuda.outputs(B, E, want[0].dtype, torch.device("cpu"))
    assert len(got) == len(want) == len(OUT)
    spans, storages = [], {}
    for name, a, b in zip(OUT, want, got):
        assert (b.shape, b.dtype, b.device) == (a.shape, a.dtype, a.device), \
            name
        assert b.is_contiguous() and b.data_ptr() % 16 == 0, name
        spans.append((b.data_ptr(), b.data_ptr() + b.nbytes, name))
        storages.setdefault(b.dtype, set()).add(
            b.untyped_storage().data_ptr())
    spans.sort()
    for (_s0, e0, n0), (s1, _e1, n1) in zip(spans, spans[1:]):
        assert e0 <= s1, (n0, n1)
    assert all(len(v) == 1 for v in storages.values()), storages
    assert len(storages) == 3
