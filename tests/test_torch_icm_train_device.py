"""ICM bank training of the port (CPU) against the JAX package.

``glimmer_mg_torch.ops.icm_train_device`` is the counterpart of
``glimmer_mg_tpu.ops.icm_train_device``. The JAX helpers run under
``jax.jit``, as ``train_icm_bank`` compiles them. Tolerances:

* ``_window_fields``, ``_select_positions`` (on the same MI input): exact;
* ``_mutual_info``: exact where no log term enters (empty nodes, zero rows
  and columns), else within 4 x 2^-23 x sum |p log r| of the 16 terms:
  each framework's ``log`` is its own (XLA's CPU ``log`` is not correctly
  rounded), measured at most 2.3;
* ``_interpolate``: within 2 f32 ulps (XLA fuses the last multiply-add into
  one FMA; measured 1);
* the level histograms: exact, against ``np.add.at`` over the same keys;
* ``train_icm_bank`` at depth 3 and 7 with 1 and 3 models on seeded reads:
  ``mip`` equal, logged probs within 8 f32 ulps (measured 4), -FLT_MAX at
  the same entries; a differing ``mip`` node is printed with the port's MI
  of both positions;
* the port's trainer against the exact host trainer ``icm_train.
  train_icm``: the bounds of tests/test_parallel.py:90-109;
* ``icm_train_check.tie_nodes`` finds a constructed near-tie and rejects
  a real difference and an MI gap past 4 x 2^-23 x sum |p log r|.
"""

import jax
import numpy as np
import pytest
import torch

from glimmer_mg_tpu.ops import icm_train_device as J
from glimmer_mg_torch.models import dna, icm_train
from glimmer_mg_torch.ops import icm_train_check as C
from glimmer_mg_torch.ops import icm_train_device as T
from glimmer_mg_torch.parallel.classify import pad_reads

from tests._torch_common import _gene_like, f32_ulps as _ulps
from tests._torch_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F32_EPS = 2.0 ** -23


def _counts(seed):
    """(600, 11, 16) pair counts with empty nodes, zero rows and zero
    columns of the 4 x 4 pair table."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 50, (600, 11, 16)).astype(np.int32)
    c[rng.random(c.shape) < 0.3] = 0
    c[:5] = 0
    c[5:10, :, 0:4] = 0
    c[10:15, :, ::4] = 0
    return c


def test_window_fields_match_jax():
    rng = np.random.default_rng(1)
    reads = rng.integers(0, 4, (6, 40), dtype=np.int32)
    lengths = np.array([40, 39, 12, 11, 3, 0], np.int32)
    want = jax.jit(J._window_fields, static_argnums=(2, 3))(
        reads, lengths, 12, 3)
    got = T._window_fields(torch.from_numpy(reads),
                           torch.from_numpy(lengths), 12, 3)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1])
def test_mutual_info_matches_jax(seed):
    c = _counts(seed)
    want = np.asarray(jax.jit(J._mutual_info)(c))
    got = T._mutual_info(torch.from_numpy(c)).numpy()
    pair = c.astype(np.float64).reshape(c.shape[:-1] + (4, 4))
    tot = np.maximum(pair.sum((-1, -2)), 1)[..., None, None]
    den = (pair.sum(-1)[..., :, None] * pair.sum(-2)[..., None, :]) / tot**2
    p = pair / tot
    with np.errstate(divide="ignore", invalid="ignore"):
        mag = np.where(pair > 0, p * np.abs(np.log(p / den)), 0.0)
    mag = mag.reshape(c.shape).sum(-1)
    assert np.array_equal(got[mag == 0], want[mag == 0])
    assert (np.abs(got.astype(np.float64) - want) <= 4 * F32_EPS * mag).all()
    assert (mag == 0).sum() >= 5 * 11  # the empty nodes


@pytest.mark.parametrize("stop_check", [False, True])
def test_select_positions_matches_jax(stop_check):
    rng = np.random.default_rng(2)
    mi = np.array(jax.jit(J._mutual_info)(_counts(2)))
    mi[:40] = 0.0  # below MUT_INFO_EPSILON: the stop rule
    # at the right-bias boundary best / 1.03, and one ulp either side
    edge = np.float32(0.5) * T._INV_BIAS
    mi[40:60] = 0.01
    mi[40:60, 0] = 0.5
    mi[40:60, 3] = [np.nextafter(edge, edge + np.float32(k % 3 - 1))
                    for k in range(20)]
    sums = rng.integers(0, 800, mi.shape[0])
    sel = jax.jit(J._select_positions, static_argnums=2)
    want = np.asarray(sel(mi, sums, stop_check))
    got = T._select_positions(torch.from_numpy(mi), torch.from_numpy(sums),
                              stop_check).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert (got == -1).any() == stop_check


def test_interpolate_matches_jax():
    rng = np.random.default_rng(3)
    ct4 = rng.integers(0, 200, (3000, 4)).astype(np.int32)
    ct4[:100] = 0
    ct4[100:200] *= 5  # past SAMPLE_SIZE_BOUND: no interpolation
    parent = rng.dirichlet(np.ones(4), 3000).astype(np.float32)
    parent[:50, 1] = 0.0
    want = np.asarray(jax.jit(J._interpolate)(ct4, parent))
    got = T._interpolate(torch.from_numpy(ct4),
                         torch.from_numpy(parent)).numpy()
    assert _ulps(got, want).max() <= 2


def test_level_histogram_matches_add_at():
    rng = np.random.default_rng(4)
    n, m, p, nodes, model_len = 5000, 3, 3, 16, 12
    model = rng.integers(0, m, n)
    frame = rng.integers(0, p, n)
    ctx = rng.integers(0, 4 ** 11, n).astype(np.int32)
    last = rng.integers(0, 4, n)
    node = rng.integers(0, nodes, n)
    valid = rng.random(n) < 0.8
    got = T.level_histogram(*(torch.from_numpy(a) for a in (
        model, frame, ctx, last, node, valid)), m, p, nodes, model_len)
    want = np.zeros((m, p, nodes, 11, 16), np.int64)
    for j in range(11):
        pair = 4 * ((ctx >> (2 * j)) & 3) + last
        np.add.at(want, (model[valid], frame[valid], node[valid], j,
                         pair[valid]), 1)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def seeded_reads():
    rng = np.random.default_rng(5)
    seqs = [_gene_like(rng, int(rng.integers(60, 199)),
                       float(rng.uniform(0.3, 0.7))) for _ in range(40)]
    return pad_reads(seqs, length=600)


@pytest.mark.parametrize("depth,n_models", [(3, 1), (3, 3), (7, 1), (7, 3)])
def test_train_icm_bank_matches_jax(seeded_reads, depth, n_models):
    reads, lengths = seeded_reads
    b = reads.shape[0]
    assign = np.zeros((b, n_models), np.float32)
    assign[np.arange(b), np.arange(b) % n_models] = 1.0
    assign[0] = 0.0  # a read in no cluster counts nowhere
    want_mip, want_probs = (np.asarray(x) for x in J.train_icm_bank(
        reads, lengths, assign, n_models=n_models, depth=depth))
    rec = {}
    mip, probs = T.train_icm_bank(
        *(torch.from_numpy(x) for x in (reads, lengths, assign)),
        n_models=n_models, depth=depth, record=rec)
    assert mip.dtype == torch.int32 and probs.dtype == torch.float32
    mip, probs = mip.numpy(), probs.numpy()
    assert mip.shape == want_mip.shape and probs.shape == want_probs.shape
    for mk, fk, node in np.argwhere(mip != want_mip)[:10]:
        level = int(np.log(3 * node + 1) / np.log(4) + 1e-9)
        first = (4 ** level - 1) // 3
        mi = rec["mi"][level][mk, fk, node - first]
        print(f"mip differs: model {mk} frame {fk} node {node}: port "
              f"{mip[mk, fk, node]} (MI {mi.tolist()}) vs JAX "
              f"{want_mip[mk, fk, node]}")
    assert np.array_equal(mip, want_mip)
    finite = want_probs > -3e38
    assert np.array_equal(finite, probs > -3e38)
    assert _ulps(probs[finite], want_probs[finite]).max() <= 8
    assert (mip[:, :, 1:] == -2).any() or depth == 3


def test_trainer_matches_host_trainer():
    """The bounds the JAX package holds its own device trainer to
    (tests/test_parallel.py:90-109)."""
    rng = np.random.default_rng(2)
    seqs = ["".join(rng.choice(list("acgt"), 400)) for _ in range(30)]
    host = icm_train.train_icm([dna.encode(s) for s in seqs], model_len=12,
                               depth=4)
    reads, lengths = pad_reads(seqs)
    mip, probs = T.train_icm_bank(
        torch.from_numpy(reads), torch.from_numpy(lengths),
        torch.ones((len(seqs), 1)), n_models=1, model_len=12, depth=4)
    mip, probs = mip.numpy()[0], probs.numpy()[0]
    assert (mip == host.mip).mean() > 0.995
    alive = (host.mip >= -1) & (mip == host.mip)
    assert np.abs(probs[alive] - host.probs[alive]).max() < 2e-2


def _tie_case():
    """Two depth-1 trainings of one model and one frame whose root MI
    differs by an ulp at the right-bias boundary of position 1."""
    edge = np.float32(0.5) * T._INV_BIAS
    mi_a = torch.tensor([[[[0.5, float(edge), 0.1]]]])
    mi_b = mi_a.clone()
    mi_b[0, 0, 0, 1] = float(np.nextafter(edge, np.float32(0)))
    mag = torch.ones((1, 1, 1, 3))
    sums = torch.full((1, 1, 1), 500, dtype=torch.int64)
    level1 = torch.full((1, 1, 4, 3), 0.2)
    mag1 = torch.full((1, 1, 4, 3), 0.5)
    sums1 = torch.full((1, 1, 4), 100, dtype=torch.int64)
    mip_a = torch.tensor([[[1, -1, -1, -1, -1]]], dtype=torch.int32)
    mip_b = mip_a.clone()
    mip_b[0, 0, 0] = 0
    probs = torch.full((1, 1, 5, 4), -1.5)
    rec_a = {"mi": [mi_a, level1], "mag": [mag, mag1], "sums": [sums, sums1]}
    rec_b = {"mi": [mi_b, level1.clone()], "mag": [mag, mag1.clone()],
             "sums": [sums, sums1.clone()]}
    return mip_a, probs, rec_a, mip_b, probs.clone(), rec_b


@pytest.mark.parametrize("case", ["near_tie", "same", "not_a_tie",
                                  "mi_gap"])
def test_tie_nodes(case):
    mip_a, probs_a, rec_a, mip_b, probs_b, rec_b = _tie_case()
    if case == "near_tie":
        ties, worst = C.tie_nodes(mip_a, probs_a, rec_a, mip_b, probs_b,
                                  rec_b)
        assert len(ties) == 1 and ties[0]["node"] == 0
        assert ties[0]["mip"] == (1, 0)
        assert ties[0]["mi_a"] != ties[0]["mi_b"]
        assert 0 < worst <= 1  # an ulp of 0.485 against a magnitude of 1
    elif case == "same":
        assert C.tie_nodes(mip_a, probs_a, rec_a, mip_a.clone(), probs_b,
                           rec_a) == ([], 0.0)
    elif case == "not_a_tie":  # the MI is the same: a differing mip is a fault
        rec_b["mi"][0] = rec_a["mi"][0].clone()
        with pytest.raises(AssertionError, match="not a mutual-information"):
            C.tie_nodes(mip_a, probs_a, rec_a, mip_b, probs_b, rec_b)
    else:  # 2e-6 at a magnitude of 1: over 4 x 2^-23, though mip agrees
        rec_b["mi"][0][0, 0, 0, 2] += 2e-6
        with pytest.raises(AssertionError, match="mutual information differs"):
            C.tie_nodes(mip_a, probs_a, rec_a, mip_a.clone(), probs_b, rec_b)
