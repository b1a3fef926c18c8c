"""KF, the frontend's CUDA kernel, against its twin on the card.

Needs an NVIDIA GPU with nvcc (marker ``cuda``); skipped elsewhere. Run on
a GPU machine with ``python -m pytest -m cuda
tests/test_torch_frontend_cuda.py -q``. The kernel
(``ops.frontend_cuda.frontend`` on CUDA tensors) must be BITWISE equal to
the twin (``ops.frontend.frontend`` on the same CUDA tensors: both take
CUDA's ``log``) on every output, padding rows included: pos, typ, sub, id,
score, trunc and n_events, and in substitution mode err_pos and err_typ.
Inputs: chunks at Lp 768 (random, overlap-dense and start-rich reads,
tiny and no-ORF reads, empty rows) and at the long reads' 2,304, batches
of 1, 37 and 2,048 reads made from them, the f64 and the f32 carry, the
RBS term on and off, every group on a user PWM, every start an event
(reads past MAX_EVENTS), and reads of 2.7-3 kb (Lp 3,072), whose
workspace outgrows a block's shared memory and goes to global scratch.
Substitution mode adds chunks with planted stop codons at the same two
shapes (2,304 takes the scratch route in this mode), each without
qualities, with a quality matrix on every row, and with one on two rows
in three (255 in the others). The call makes no host sync, bad inputs
(bad qualities too) raise before a launch, and ``predict_batch_device``
on CUDA launches KF once in each mode and gives the CPU run's records.
The redesign's own checks: every instantiation holds at least 4 reads an
SM error-free and 3 in substitution mode at Lp 768; reads padded to just
below and to NARROW_LP (the narrow and the wide index type); a chunk in
which every read has more than 32 events.
"""

import numpy as np
import pytest
import torch

from glimmer_mg_torch.ops import device_predict as tdp
from glimmer_mg_torch.ops import frontend, frontend_cuda, icm_score

from tests._torch_common import (  # noqa: F401  (fixture)
    batch_inputs, class_map, long_reads, overlap_dense_reads,
    planted_stop_reads, quality_map, random_reads, start_rich_reads,
    trained_models,
)

pytestmark = pytest.mark.cuda

OUT = ("pos", "typ", "sub", "id", "score", "trunc")
OUT_SUBS = OUT + ("err_pos", "err_typ")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def chunks(trained_models):
    """Padded chunks as the engine buckets them (numpy): Lp 768, the long
    reads' 2,304 and 3,072; the last rows of each are empty (n = 0)."""
    gd, classes = trained_models
    short = (random_reads(31, 24, lo=30, hi=700)
             + overlap_dense_reads(32, 16, length=700)
             + start_rich_reads(33, 20))
    subs = (planted_stop_reads(36, 40, lo=600, hi=760)
            + random_reads(37, 8, lo=30, hi=700)
            + start_rich_reads(38, 8))
    subs_long = (planted_stop_reads(39, 8, lo=1800, hi=2300)
                 + long_reads(40, 4))
    out = {}
    for name, reads, l_pad, b_pad in (
            ("768", short, 768, 64), ("2304", long_reads(34, 12), 2304, 16),
            ("3072", long_reads(35, 6, lo=2700, hi=3000), 3072, 8),
            ("subs768", subs, 768, 60), ("subs2304", subs_long, 2304, 14)):
        cmap = class_map(reads, classes, pair_every=3)
        out[name] = batch_inputs(reads, cmap, gd, l_pad=l_pad, b_pad=b_pad)
        out[name + "_quals"] = quality_map(reads, 41)
        out[name + "_reads"] = reads
    return out


def quality_matrix(chunks, chunk, which):
    """(B, Lp) uint8 qualities of a chunk: None, "all" rows (a Phred value
    in [1, 254] at each of a read's bases), or "partial" (the rows
    ``quality_map`` gives, two in three; 255 in the others and past each
    read's end, as the engine uploads them)."""
    if which == "none":
        return None
    _m, seqs, lengths, _g = chunks[chunk]
    q = np.full(seqs.shape, 255, np.uint8)
    rng = np.random.default_rng(43)
    quals = chunks[chunk + "_quals"]
    for r, (h, _s) in enumerate(chunks[chunk + "_reads"]):
        if which == "all":
            q[r, :lengths[r]] = rng.integers(1, 255, lengths[r])
        elif h in quals:
            q[r, :lengths[r]] = np.minimum(quals[h], 254)
    return torch.from_numpy(q)


class Case:
    """One chunk's frontend arguments on a device."""

    def __init__(self, batch, device, *, f64=True, rbs=True, user=False,
                 thresh=None, subs=False, quals=None):
        models_list, seqs, lengths, groups = batch
        Lp = seqs.shape[1]
        assert Lp % 3 == 0
        bank = tdp.build_bank(models_list, Lp)
        if thresh is not None:
            bank.event_threshold = bank.start_threshold = thresh
        cpu = tdp.bank_to_device(bank, "cpu")
        if user:
            # every group on a user log-odds PWM of the mixture's width
            cpu["pwm_is_user"][:] = True
            cpu["pwm_user"] = (torch.log(cpu["pwm_cols"][:, 0] + 0.05)
                               - np.log(0.25)).contiguous()
        t = torch.from_numpy
        reads, lens, grp = t(seqs), t(lengths), t(groups)
        g6, i6 = icm_score.mg_six_frame_batch(
            cpu["gene_mip"], cpu["gene_probs"], cpu["indep_mip"],
            cpu["indep_probs"], reads, lens, grp, model_len=bank.model_len,
            depth=bank.depth)
        self.bank = {k: v.to(device) for k, v in cpu.items()}
        self.arrays = [x.to(device) for x in (reads, lens, grp, g6, i6)]
        self.quals = None if quals is None else quals.to(device)
        self.Lp = Lp
        self.consts = dict(
            min_gene_len=bank.min_gene_len, max_olap=bank.max_olap,
            event_threshold=bank.event_threshold,
            start_threshold=bank.start_threshold, ws=bank.ribosome_window,
            W=bank.pwm_w if rbs else 0,
            fdt=torch.float64 if f64 else torch.float32, subs=subs)

    def tiled(self, idx):
        """The same case over the reads ``idx`` (a batch made of them)."""
        out = object.__new__(Case)
        out.__dict__.update(self.__dict__)
        idx = torch.as_tensor(np.asarray(idx), device=self.arrays[0].device)
        out.arrays = [a[idx].contiguous() for a in self.arrays]
        if self.quals is not None:
            out.quals = self.quals[idx].contiguous()
        return out

    def args(self):
        s, n, g, g6, i6 = self.arrays
        return (s, n, g, g6, i6, self.bank, self.Lp, self.consts,
                tdp.MAX_EVENTS)

    def run(self, fn):
        return fn(*self.args(), quals=self.quals)


def kernel(case):
    """One counted launch of KF, synchronised."""
    frontend_cuda.reset_launches()
    out = case.run(frontend_cuda.frontend)
    torch.cuda.synchronize()
    assert frontend_cuda.launches == 1
    return out


def assert_bitwise(want, got):
    (wev, wn), (gev, gn) = want, got
    assert wn.dtype == gn.dtype == torch.int32
    assert torch.equal(wn.cpu(), gn.cpu()), int((wn != gn).sum())
    assert set(wev) == set(gev)
    for name in OUT_SUBS if "err_pos" in wev else OUT:
        a, b = wev[name].cpu(), gev[name].cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.is_floating_point:
            iv = torch.int64 if a.dtype == torch.float64 else torch.int32
            a, b = a.view(iv), b.view(iv)
        assert torch.equal(a, b), (name, int((a != b).sum()))


@pytest.fixture(scope="module")
def cases(cuda, chunks):
    cache = {}

    def get(chunk, quals="none", **kw):
        key = (chunk, quals, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = Case(chunks[chunk], cuda,
                              quals=quality_matrix(chunks, chunk, quals),
                              **kw)
        return cache[key]
    return get


@pytest.mark.parametrize("rbs", [True, False], ids=["rbs", "no_rbs"])
@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("b", [1, 37, 2048])
@pytest.mark.parametrize("chunk", ["768", "2304"])
def test_kernel_bitwise_equals_twin(cases, chunk, b, f64, rbs):
    """Batches of b reads drawn from the chunk (its most event-rich read
    alone for b = 1)."""
    case = cases(chunk, f64=f64, rbs=rbs)
    if b == 1:
        _ev, n = frontend.frontend(*case.args())
        idx = [int(torch.argmax(n))]
    else:
        idx = np.random.default_rng(b).integers(0, case.arrays[0].shape[0],
                                                b)
    case = case.tiled(idx)
    assert_bitwise(frontend.frontend(*case.args()), kernel(case))


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_kernel_user_pwm(cases, f64):
    case = cases("768", f64=f64, user=True)
    want = frontend.frontend(*case.args())
    assert_bitwise(want, kernel(case))


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_kernel_every_start_an_event(cases, f64):
    """Thresholds -1e9: reads past MAX_EVENTS (n_events counts them all),
    next to empty, tiny and no-ORF reads."""
    case = cases("768", f64=f64, thresh=-1e9)
    want = frontend.frontend(*case.args())
    n = want[1].cpu()
    assert (n > tdp.MAX_EVENTS).sum() >= 3
    assert (n == 0).sum() >= 4
    assert (case.arrays[1].cpu() == 0).sum() >= 4
    assert_bitwise(want, kernel(case))


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_kernel_global_scratch(cases, cuda, f64):
    """Reads of 2.7-3 kb: the workspace outgrows a block's shared memory
    and goes to a global scratch buffer (a few blocks an SM, each looping
    over reads: 300 reads here)."""
    case = cases("3072", f64=f64)
    assert (frontend_cuda.workspace_bytes(case.Lp, f64)
            > frontend_cuda._smem_room(cuda, f64, True))
    case = case.tiled(np.arange(300) % 8)
    assert_bitwise(frontend.frontend(*case.args()), kernel(case))


def test_kernel_makes_no_host_sync(cases):
    case = cases("768", f64=True)
    kernel(case)  # built and loaded
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = frontend_cuda.frontend(*case.args())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert_bitwise(frontend.frontend(*case.args()), out)


@pytest.mark.parametrize("quals", ["none", "all", "partial"])
@pytest.mark.parametrize("rbs", [True, False], ids=["rbs", "no_rbs"])
@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("b", [1, 37, 2048])
@pytest.mark.parametrize("chunk", ["subs768", "subs2304"])
def test_subs_kernel_bitwise_equals_twin(cases, chunk, b, f64, rbs, quals):
    """Substitution mode: batches of b reads drawn from a chunk of reads
    with planted stop codons (its most event-rich read alone for b = 1),
    without qualities, with qualities on every row, and on two rows in
    three (the rest 255)."""
    case = cases(chunk, quals=quals, f64=f64, rbs=rbs, subs=True)
    if b == 1:
        _ev, n = case.run(frontend.frontend)
        idx = [int(torch.argmax(n))]
    else:
        idx = np.random.default_rng(b).integers(0, case.arrays[0].shape[0],
                                                b)
    case = case.tiled(idx)
    want = case.run(frontend.frontend)
    ev, n = want
    live = (torch.arange(ev["pos"].shape[1], device=n.device)[None]
            < n.clamp(max=ev["pos"].shape[1])[:, None])
    if b > 1:
        assert int(((ev["err_typ"] == 2) & live).sum()) > 0
    assert_bitwise(want, kernel(case))


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_subs_kernel_every_start_an_event(cases, f64):
    """Substitution mode with thresholds -1e9: reads past MAX_EVENTS
    (n_events counts them all), with qualities on two rows in three."""
    case = cases("subs768", quals="partial", f64=f64, thresh=-1e9,
                 subs=True)
    want = case.run(frontend.frontend)
    assert (want[1].cpu() > tdp.MAX_EVENTS).sum() >= 3
    assert_bitwise(want, kernel(case))


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_subs_kernel_global_scratch(cases, cuda, f64):
    """Substitution mode at Lp 2,304: the workspace (8 Lp + 33 candidates,
    the sub families' arrays) outgrows a block's shared memory and goes to
    global scratch (a few blocks an SM, each looping over reads: 300
    reads here)."""
    case = cases("subs2304", quals="partial", f64=f64, subs=True)
    assert (frontend_cuda.workspace_bytes(case.Lp, f64, subs=True)
            > frontend_cuda._smem_room(cuda, f64, True, subs=True))
    assert (frontend_cuda.workspace_bytes(768, f64, subs=True)
            <= frontend_cuda._smem_room(cuda, f64, True, subs=True))
    case = case.tiled(np.arange(300) % case.arrays[0].shape[0])
    assert_bitwise(case.run(frontend.frontend), kernel(case))


@pytest.mark.parametrize("quals", ["none", "partial"])
def test_subs_kernel_makes_no_host_sync(cases, quals):
    case = cases("subs768", quals=quals, f64=True, subs=True)
    kernel(case)  # built and loaded, _CP_TAB on the card
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = case.run(frontend_cuda.frontend)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert_bitwise(case.run(frontend.frontend), out)


@pytest.mark.parametrize("bad", ["int64", "cpu", "short", "strided",
                                 "int8"])
def test_subs_bad_quals_raise_before_launch(cases, bad):
    case = cases("subs768", quals="partial", f64=True, subs=True)
    q = case.quals
    if bad == "int64":
        q = q.long()
    elif bad == "cpu":
        q = q.cpu()
    elif bad == "short":
        q = q[:, :-3].contiguous()
    elif bad == "strided":
        q = q.t().contiguous().t()
    else:
        q = q.to(torch.int8)
    frontend_cuda.reset_launches()
    with pytest.raises((TypeError, ValueError)):
        frontend_cuda.frontend(*case.args(), quals=q)
    assert frontend_cuda.launches == 0


@pytest.mark.parametrize("bad", ["int64_seq", "cpu_n", "short_gene6",
                                 "strided_ind6", "f64_gene6", "Lp",
                                 "int64_groups", "short_len_score"])
def test_bad_inputs_raise_before_launch(cases, bad):
    case = cases("768", f64=True)
    s, n, g, g6, i6, bank, Lp, consts, E = case.args()
    bank = dict(bank)
    if bad == "int64_seq":
        s = s.long()
    elif bad == "cpu_n":
        n = n.cpu()
    elif bad == "short_gene6":
        g6 = g6[:, :5].contiguous()
    elif bad == "strided_ind6":
        i6 = i6.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "f64_gene6":
        g6 = g6.double()
    elif bad == "Lp":
        Lp = Lp - 1
    elif bad == "int64_groups":
        g = g.long()
    else:
        bank["len_score"] = bank["len_score"][:, :2].contiguous()
    frontend_cuda.reset_launches()
    with pytest.raises((TypeError, ValueError)):
        frontend_cuda.frontend(s, n, g, g6, i6, bank, Lp, consts, E)
    assert frontend_cuda.launches == 0


@pytest.mark.parametrize("mode", ["error_free", "subs", "subs_quals"])
def test_predict_batch_device_launches_kf(cuda, chunks, mode):
    """The device batch entry point on CUDA tensors launches KF once a
    chunk in each mode (substitution mode with and without a quality
    file), and returns the CPU run's records (scores at %8.2f: log and the
    six-frame walk are each device's own)."""
    chunk = "768" if mode == "error_free" else "subs768"
    models_list, seqs, lengths, groups = chunks[chunk]
    bank = tdp.build_bank(models_list, seqs.shape[1])
    cpu = [torch.from_numpy(a) for a in (seqs, lengths, groups)]
    dev = tdp.bank_to_device(bank, "cpu")
    g6, i6 = icm_score.mg_six_frame_batch(
        dev["gene_mip"], dev["gene_probs"], dev["indep_mip"],
        dev["indep_probs"], *cpu, model_len=bank.model_len, depth=bank.depth)
    q = (quality_matrix(chunks, chunk, "partial") if mode == "subs_quals"
         else None)
    outs = []
    for device in ("cpu", cuda):
        frontend_cuda.reset_launches()
        outs.append(tdp.predict_batch_device(
            bank, tdp.bank_to_device(bank, device),
            *(x.to(device) for x in (*cpu, g6, i6)),
            subs=mode != "error_free",
            quals=None if q is None else q.to(device)))
        assert frontend_cuda.launches == (device == cuda)
    fmt = np.vectorize(lambda x: "%8.2f" % x)
    names = ("g_id g_stop g_len g_sign g_trunc g_score g_epos g_etyp cnt "
             "n_flag").split()
    for name, a, b in zip(names, *outs):
        if name == "g_score":
            assert (fmt(a) == fmt(b)).all(), name
        else:
            assert np.array_equal(a, b), name
    assert outs[0][8].sum() > 20


# ---- the Hopper redesign: occupancy, the index type's threshold, large nv

@pytest.mark.parametrize("subs", [False, True], ids=["error_free", "subs"])
@pytest.mark.parametrize("rbs", [True, False], ids=["rbs", "no_rbs"])
@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_kernel_blocks_per_sm_at_lp768(cuda, f64, rbs, subs):
    """Every instantiation holds at least 4 reads an SM error-free and 3 in
    substitution mode at the main path's Lp 768, its workspace in shared
    memory (the kernel's target; cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    assert (frontend_cuda.workspace_bytes(768, f64, subs)
            <= frontend_cuda._smem_room(cuda, f64, rbs, subs))
    assert frontend_cuda.blocks_per_sm(768, f64, rbs, subs) >= (
        3 if subs else 4)


@pytest.fixture(scope="module")
def threshold_chunk(trained_models):
    """Reads of 7.7-8.1 kb, two with planted stop codons (numpy), and their
    qualities on two reads in three."""
    gd, classes = trained_models
    reads = (long_reads(44, 3, lo=7700, hi=8100)
             + planted_stop_reads(45, 2, lo=7700, hi=8100))
    return gd, classes, reads, quality_map(reads, 46)


@pytest.mark.parametrize("subs", [False, True], ids=["error_free", "subs"])
@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("side", ["below", "at"])
def test_kernel_bitwise_at_narrow_index_threshold(cuda, threshold_chunk,
                                                  side, f64, subs):
    """Lp just below NARROW_LP (int16_t scans and ids, 32-bit sort keys) and
    at it (int, 64-bit keys), the same reads padded to each: bitwise to the
    twin, in substitution mode with qualities on two rows in three."""
    gd, classes, reads, quals = threshold_chunk
    Lp = frontend_cuda.narrow_lp() - (3 if side == "below" else 0)
    batch = batch_inputs(reads, class_map(reads, classes, pair_every=3), gd,
                         l_pad=Lp, b_pad=6)
    q = None
    if subs:
        _m, seqs, lengths, _g = batch
        qm = np.full(seqs.shape, 255, np.uint8)
        for r, (h, _s) in enumerate(reads):
            if h in quals:
                qm[r, :lengths[r]] = np.minimum(quals[h], 254)
        q = torch.from_numpy(qm)
    case = Case(batch, cuda, f64=f64, subs=subs, quals=q)
    want = case.run(frontend.frontend)
    assert int(want[1].sum()) > 20
    assert_bitwise(want, kernel(case))


@pytest.mark.parametrize("subs", [False, True], ids=["error_free", "subs"])
@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_kernel_every_read_past_32_events(cases, f64, subs):
    """A chunk in which every read has more than 32 valid candidates (the
    reads of the thresholds -1e9 chunk that do, 64 of them): the ranks of
    the sort over many keys, bitwise."""
    case = cases("subs768" if subs else "768",
                 quals="partial" if subs else "none", f64=f64, thresh=-1e9,
                 subs=subs)
    _ev, n = case.run(frontend.frontend)
    idx = torch.nonzero(n > 32).flatten().cpu().numpy()
    assert len(idx) >= 4
    case = case.tiled(np.resize(idx, 64))
    want = case.run(frontend.frontend)
    assert bool((want[1] > 32).all())
    assert_bitwise(want, kernel(case))
