"""K3, the event-DP and traceback CUDA kernel, against its twin on the card.

Needs an NVIDIA GPU with nvcc (marker ``cuda``); skipped elsewhere. Run
on a GPU machine with ``python -m pytest tests/test_torch_event_dp_cuda.py
-q``. The kernel must be BITWISE equal to the twin
(``ops.event_dp.event_dp_traceback``) on every output (score, bp, best,
wovf, the eight gene arrays, cnt) over the frontend rows of
``tests/test_torch_event_dp.py`` (error-free, substitution mode with and
without a quality file, f64 and f32, ties, event-dense reads with wovf
and reads at MAX_EVENTS, E = 40), batches of 1, 37 and 2,048 reads made
from them, and random event rows (cyclic predecessor graphs included):
E = 161 and 1,024 (MAX_E), tables too large for shared memory (the
kernel reads them from the bank), one block of four groups, NaN and -0
scores, and a cyclic read in the last block of a 2,048-read batch whose
longest read sits in the first.
The call makes no host sync (``torch.cuda.set_sync_debug_mode("error")``),
and a bad dtype or device raises before a launch. ``predict_batch_device``
on CUDA tensors launches K3 and gives the CPU run's records.
"""

import numpy as np
import pytest
import torch

from glimmer_mg_torch.ops import device_predict as tdp
from glimmer_mg_torch.ops import event_dp, event_dp_cuda, icm_score

from tests.test_torch_event_dp import (  # noqa: F401  (fixtures)
    CASES, OUT, case_rows, chunks, one_torch_thread, twin,
    trained_models,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def on(rows, device):
    ev, tables, groups, consts, ne = rows
    return ({k: v.to(device) for k, v in ev.items()},
            {k: v.to(device) for k, v in tables.items()}, groups.to(device),
            consts, ne.to(device))


def tiled(rows, idx):
    """The rows of reads ``idx`` (a batch made of the case's reads)."""
    ev, tables, groups, consts, ne = rows
    idx = torch.as_tensor(idx)
    return ({k: v[idx].contiguous() for k, v in ev.items()}, tables,
            groups[idx].contiguous(), consts, ne[idx].contiguous())


def kernel(rows):
    """One counted launch of K3, synchronised."""
    event_dp_cuda.reset_launches()
    out = event_dp_cuda.event_dp_traceback(*rows)
    torch.cuda.synchronize()
    assert event_dp_cuda.launches == 1
    return out


def assert_bitwise(want, got):
    for name, a, b in zip(OUT, want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        a, b = a.cpu(), b.cpu()
        if a.dtype.is_floating_point:
            iv = torch.int64 if a.dtype == torch.float64 else torch.int32
            a, b = a.view(iv), b.view(iv)
        assert torch.equal(a, b), (name, int((a != b).sum()))


@pytest.fixture(scope="module")
def card_rows(cuda, chunks):
    cache = {}

    def get(case, f64):
        if (case, f64) not in cache:
            cache[case, f64] = case_rows(chunks, case, f64)
        return cache[case, f64]
    return get


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_bitwise_equals_twin(card_rows, cuda, case, f64):
    rows = card_rows(case, f64)
    assert_bitwise(twin(rows), kernel(on(rows, cuda)))  # the twin on the CPU


@pytest.mark.parametrize("b", [1, 37, 2048])
@pytest.mark.parametrize("case", ["error_free", "subs_quality_file",
                                  "subs_dense_wovf"])
def test_kernel_bitwise_batches(card_rows, cuda, case, b):
    """Batches of b reads drawn from the case's reads (the event-densest
    read alone for b = 1); the twin runs on the card for b = 2,048."""
    rows = card_rows(case, True)
    ne = rows[4]
    if b == 1:
        idx = [int(torch.argmax(ne))]
    else:
        idx = np.random.default_rng(b).integers(0, ne.shape[0], b)
    rows = tiled(rows, idx)
    if b > 64:
        rows = on(rows, cuda)
    assert_bitwise(twin(rows), kernel(on(rows, cuda)))


def random_rows(seed, B, E, f64, err, dense=False, mixed=False, D=104,
                groups=None, nan=0.0):
    """Random event rows (cyclic predecessor graphs included): sorted
    positions, random types, subs, ids, scores and 7 groups' adjacency
    tables of length D on a grid of 0.5 (ties), -0 and -inf scores (and
    NaN at the rate ``nan``); every read at ne = E, or with ``mixed`` at a
    random ne with typ == 0 rows after it (where a cycle makes the
    traceback run to the batch's bound); random groups, or ``groups``."""
    rng = np.random.default_rng(seed)
    G = 7
    pos = np.cumsum(rng.integers(0, 3 if dense else 12, (B, E)), axis=1)
    score = np.round(rng.normal(0, 4, (B, E)) * 2) / 2
    score[rng.random((B, E)) < 0.2] = 0.0
    score[rng.random((B, E)) < 0.03] = -0.0
    score[rng.random((B, E)) < 0.02] = -np.inf
    if nan:
        score[rng.random((B, E)) < nan] = np.nan
    t = torch.from_numpy
    ev = dict(pos=t(pos.astype(np.int32)),
              typ=t(rng.integers(1, 5, (B, E)).astype(np.int32)),
              sub=t(rng.integers(0, 6, (B, E)).astype(np.int32)),
              id=t(rng.integers(0, 6, (B, E)).astype(np.int32)),
              score=t(score).to(torch.float64 if f64 else torch.float32),
              trunc=t(rng.random((B, E)) < 0.3))
    if err:
        ep = np.where(rng.random((B, E)) < 0.3,
                      pos + rng.integers(-60, 60, (B, E)), -1)
        ev["err_pos"] = t(ep.astype(np.int32))
        ev["err_typ"] = t(np.where(ep >= 0, 2, -1).astype(np.int32))
    grid = lambda *shape: np.round(rng.normal(0, 2, shape) * 2) / 2  # noqa
    tables = dict(adj_or=t(grid(G, 4).astype(np.float32)),
                  adj_dist=t(grid(G, 3, D).astype(np.float32)),
                  adj_dist_len=t(rng.integers(1, D + 1, (G, 3))
                                 .astype(np.int32)))
    ne = np.full(B, E, np.int32)
    if mixed:
        ne = rng.integers(0, E + 1, B).astype(np.int32)
        ev["typ"][torch.arange(E)[None, :] >= t(ne)[:, None]] = 0
    grp = rng.integers(0, G, B) if groups is None else np.asarray(groups)
    return (ev, tables, t(grp.astype(np.int32)), {"max_olap": 50}, t(ne))


@pytest.mark.parametrize("err", [False, True], ids=["no_err", "err"])
@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("E,dense,mixed", [
    (160, False, False), (160, True, False), (160, False, True),
    (47, False, False), (1, False, False)])
def test_kernel_bitwise_random_rows(cuda, E, dense, mixed, f64, err):
    rows = random_rows(E + 7 * dense + 3 * mixed, 96, E, f64, err, dense,
                       mixed)
    want = twin(rows)
    assert_bitwise(want, kernel(on(rows, cuda)))
    if dense and E == 160:
        assert want[3].any()  # wovf raised


@pytest.mark.parametrize("err", [False, True], ids=["no_err", "err"])
@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("E,B", [(161, 64), (1024, 4)])
def test_kernel_bitwise_wide_rows(cuda, E, B, f64, err):
    """Rows past the smoke's E = 160: 161, and MAX_E = 1,024 (the most a
    block's shared memory holds at four reads a block)."""
    rows = random_rows(E, B, E, f64, err, mixed=E < 1024)
    assert_bitwise(twin(rows), kernel(on(rows, cuda)))


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_kernel_tables_in_device_memory(cuda, f64):
    """D = 6,000: 72 KB of adjacency tables a read, far more than a
    read's rows take in shared memory; the kernel reads them from the bank
    through the read-only cache, at every distance the rows reach."""
    rows = random_rows(23, 96, 160, f64, True, D=6000)
    assert_bitwise(twin(rows), kernel(on(rows, cuda)))


def test_kernel_one_block_four_groups(cuda):
    """Two blocks of four reads, each read of another group."""
    rows = random_rows(29, 8, 160, True, True, groups=[0, 1, 2, 3, 6, 5, 4, 3])
    assert_bitwise(twin(rows), kernel(on(rows, cuda)))


def assert_same_nan(want, got):
    """Integer outputs equal; float outputs bitwise equal where the twin's
    is a number and NaN where it is NaN (the payload of a NaN is the
    device's arithmetic's, not the algorithm's)."""
    for name, a, b in zip(OUT, want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        a, b = a.cpu(), b.cpu()
        if a.dtype.is_floating_point:
            nan = torch.isnan(a)
            assert torch.equal(nan, torch.isnan(b)), name
            iv = torch.int64 if a.dtype == torch.float64 else torch.int32
            a, b = a[~nan].view(iv), b[~nan].view(iv)
        assert torch.equal(a, b), (name, int((a != b).sum()))


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_kernel_nan_and_negative_zero_scores(cuda, f64):
    """NaN (3%) and -0 (3%) scores in candidate rows: NaN candidates make
    the opener's maximum NaN and its winner 0, a NaN among the same-id
    scores makes m_fs NaN and w_fs -1; -0 becomes +0."""
    rows = random_rows(31, 96, 160, f64, False, nan=0.03)
    score = rows[0]["score"]
    assert torch.isnan(score).any()
    assert ((score == 0) & torch.signbit(score)).any()
    want = twin(rows)
    assert torch.isnan(want[0]).any()
    assert_same_nan(want, kernel(on(rows, cuda)))


def test_kernel_cyclic_read_beside_the_longest(card_rows, cuda):
    """A cyclic predecessor graph (subs_dense_wovf's max_olap 300) in the
    last block of a 2,048-read batch whose longest read sits in the first
    block: the read's traceback runs on past its own ne, to the batch's
    bound, which the kernel reads from ne. The twin runs on the card."""
    rows = card_rows("subs_dense_wovf", True)
    ne = rows[4]
    top = int(torch.argmax(ne))
    card = on(rows, cuda)
    ev, tables, groups, consts, ne_c = card
    # reads whose chain outlives their own bound: their gene count at
    # their own bound (a batch of the reads with their ne) differs from
    # the one beside the longest read (a batch of every read). A read's
    # DP rows do not depend on its batch, so the twin's DP runs once.
    dp = event_dp.event_dp_batched(
        ev, event_dp._prefetch_adj(tables, groups), consts, ne_c)

    def cnt(idx):
        sub = tiled(card, idx)
        idx = idx.to(cuda)
        return event_dp.traceback_batched(
            sub[0], dp[0][idx], dp[1][idx], dp[2][idx], sub[4])[-1].cpu()
    beside = cnt(torch.arange(ne.shape[0]))
    own = torch.empty_like(beside)
    for n in torch.unique(ne).tolist():
        idx = torch.nonzero(ne == n)[:, 0]
        own[idx] = cnt(idx)
    cyc = torch.nonzero((own != beside) & (ne < ne[top]))[:, 0].tolist()
    assert cyc
    idx = np.random.default_rng(2048).integers(0, ne.shape[0], 2048)
    idx[0] = top
    idx[-4:] = (cyc * 4)[:4]
    batch = on(tiled(rows, idx), cuda)
    want = twin(batch)
    alone = twin(tiled(card, idx[-1:]))
    assert int(want[12][-1]) > int(alone[12][0])
    assert_bitwise(want, kernel(batch))


def test_kernel_makes_no_host_sync(card_rows, cuda):
    rows = on(tiled(card_rows("subs_quality_file", True), [0] * 8 + [3] * 8),
              cuda)
    event_dp_cuda.event_dp_traceback(*rows)  # built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = event_dp_cuda.event_dp_traceback(*rows)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert_bitwise(twin(rows), out)


@pytest.mark.parametrize("case", ["int64_pos", "f16_score", "cpu_ne",
                                  "strided_typ", "short_tab", "cpu_groups"])
def test_bad_inputs_raise_before_launch(card_rows, cuda, case):
    ev, tables, groups, consts, ne = on(card_rows("subs", True), cuda)
    ev, tables = dict(ev), dict(tables)
    if case == "int64_pos":
        ev["pos"] = ev["pos"].long()
    elif case == "f16_score":
        ev["score"] = ev["score"].half()
    elif case == "cpu_ne":
        ne = ne.cpu()
    elif case == "strided_typ":
        ev["typ"] = ev["typ"].t().contiguous().t()
    elif case == "short_tab":
        tables["adj_dist"] = tables["adj_dist"][:, :2].contiguous()
    else:
        groups = groups.cpu()
    event_dp_cuda.reset_launches()
    with pytest.raises((TypeError, ValueError)):
        event_dp_cuda.event_dp_traceback(ev, tables, groups, consts, ne)
    assert event_dp_cuda.launches == 0


def test_predict_batch_device_launches_k3(cuda, chunks):
    """The device batch entry point on CUDA tensors reaches K3 (one launch)
    and returns the CPU run's records (scores at %8.2f: the frontend's
    sums are each device's own)."""
    (models_list, seqs, lengths, groups), _q = chunks["subs"]
    bank = tdp.build_bank(models_list, seqs.shape[1])
    cpu = [torch.from_numpy(a) for a in (seqs, lengths, groups)]
    dev = tdp.bank_to_device(bank, "cpu")
    g6, i6 = icm_score.mg_six_frame_batch(
        dev["gene_mip"], dev["gene_probs"], dev["indep_mip"],
        dev["indep_probs"], *cpu, model_len=bank.model_len, depth=bank.depth)
    outs = []
    for device in ("cpu", cuda):
        event_dp_cuda.reset_launches()
        outs.append(tdp.predict_batch_device(
            bank, tdp.bank_to_device(bank, device),
            *(x.to(device) for x in (*cpu, g6, i6)), subs=True))
        assert event_dp_cuda.launches == (device == cuda)
    fmt = np.vectorize(lambda x: "%8.2f" % x)
    for name, a, b in zip(OUT[4:] + ["n_flag"], *outs):
        if name == "g_score":
            assert (fmt(a) == fmt(b)).all(), name
        else:
            assert np.array_equal(a, b), name
    assert outs[0][8].sum() > 10
