"""K1's algorithm on the CPU: folded prob tables and the packed-window walk.

The six-frame kernel (``csrc/six_frame.cu``) reads prob tables with the
pruned back-up folded in (``icm_cuda.fold_pruned_probs``, the JAX
package's ``pack_tables_exact`` table) and takes each position's context,
null context and last base as bit fields of one window cut from 2-bit
packed words. ``_packed_window_walk`` repeats that algorithm in plain
torch; it must be BITWISE equal to the twin ``mg_six_frame_batch`` over
the whole (B, 6, L) output, pads included.
"""

import numpy as np
import pytest
import torch

from glimmer_mg_tpu.ops import icm_pallas
from glimmer_mg_torch.ops import icm_cuda, icm_score as tis

from tests.test_torch_icm_score import _make_bank

PAD = 16  # packed index q = j + PAD, as the kernel's kPad


def _trained_bank():
    """Two depth-7 gene ICMs plus a depth-3 one; lengths L, 3 and 0 first."""
    b = _make_bank(3, (7, 7, 3), 7, 384)
    assert tuple(b[5][:3]) == (384, 3, 0)
    return b


def _pruned_bank():
    """The trained bank with a fifth of the non-root nodes of every table
    marked pruned (-2). Training marks only the children of leaves, which
    no walk reaches; here walks do land on pruned nodes and take their
    parent's probs."""
    b = list(_trained_bank())
    rng = np.random.default_rng(11)
    for t in (0, 2):
        mip = b[t].copy()
        hit = rng.random(mip.shape) < 0.2
        hit[..., 0] = False
        mip[hit] = -2
        b[t] = mip
    return tuple(b)


@pytest.fixture(scope="module", params=["trained", "pruned"])
def bank(request):
    return _trained_bank() if request.param == "trained" else _pruned_bank()


def _packed_words(seq, l):
    """(B, NW) int64 words: 16 bases a word, base q at bits 2(q & 15)."""
    nw = (l + PAD) // 16 + 2
    padded = torch.zeros((seq.shape[0], nw * 16), dtype=torch.int64)
    padded[:, PAD:PAD + l] = seq
    shifts = 2 * torch.arange(16, dtype=torch.int64)
    return (padded.reshape(-1, nw, 16) << shifts).sum(dim=-1)


def _walk(mip, off, ctx, thresh, depth):
    """Branch-free walk over a flat mip table, no back-up: a stopped walk
    keeps its node. Returns the final node of each position."""
    node = torch.zeros_like(ctx)
    for _ in range(depth):
        pos = mip[off + node]
        b = (ctx >> (2 * pos.clamp(min=0))) & 3
        node = torch.where(pos >= thresh, 4 * node + b + 1, node)
    return node


def _packed_window_walk(gmip, gprobs_f, imip, iprobs_f, reads, lengths,
                        group, model_len, depth):
    b, l = reads.shape
    _g, p, n = gmip.shape
    n2 = imip.shape[2]
    w = model_len - 1
    reads = reads.long()
    lens = lengths.long()[:, None]
    j = torch.arange(l)[None, :]
    inside = j < lens
    rev = torch.where(inside, reads.gather(
        1, (lens - 1 - j).clamp(min=0)), 0)
    comp = torch.where(inside, reads ^ 3, 0)
    i = torch.arange(l)
    q0 = i - w + PAD
    k, sh = q0 >> 4, 2 * (q0 & 15)
    thresh = (w - i).clamp(min=0)
    thresh_null = (2 - i).clamp(min=0)
    gm = gmip.reshape(-1).long()
    gp = gprobs_f.reshape(-1, 4)
    im = imip.reshape(-1).long()
    ip = iprobs_f.reshape(-1, 4)
    grp = group.long()[:, None]
    gout, iout = [], []
    for seq in (rev, comp):
        words = _packed_words(seq, l)
        x = ((words[:, k + 1] << 32) | words[:, k]) >> sh
        ctx = x & ((1 << (2 * w)) - 1)
        ctx_null = (x >> (2 * (w - 2))) & 15
        last = (x >> (2 * w)) & 3
        for f in range(3):
            goff = (grp * p + f % p) * n
            node = _walk(gm, goff, ctx, thresh, depth)
            gout.append(gp[goff + node, last])
            ioff = (grp * 3 + f) * n2
            node = _walk(im, ioff, ctx_null, thresh_null, 2)
            iout.append(ip[ioff + node, last])
    return torch.stack(gout, dim=1), torch.stack(iout, dim=1)


def test_fold_equals_pack_tables_exact(bank):
    gmip, gprobs = bank[0], bank[1]
    assert (gmip == -2).any()  # the bank has pruned nodes
    m, p, n = gmip.shape
    _lm, probs_x = icm_pallas.pack_tables_exact(gmip, gprobs, depth=7)
    want = probs_x.reshape(m * p, -1)[:, :n * 4]
    got = icm_cuda.fold_pruned_probs(torch.from_numpy(gmip),
                                     torch.from_numpy(gprobs))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().reshape(m * p, n * 4).view(np.int32),
                          want.view(np.int32))


@pytest.mark.parametrize("mip_dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("model_len", [3, 12, 17])
@pytest.mark.parametrize("depth", [3, 7])
def test_packed_window_walk_bitwise_equals_twin(bank, depth, model_len,
                                                mip_dtype):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in bank]
    t[0], t[2] = t[0].to(mip_dtype), t[2].to(mip_dtype)
    gmip, gprobs, imip, iprobs, reads, lengths, group = t
    folded = (icm_cuda.fold_pruned_probs(gmip, gprobs),
              icm_cuda.fold_pruned_probs(imip, iprobs))
    got_g, got_i = _packed_window_walk(gmip, folded[0], imip, folded[1],
                                       reads, lengths, group, model_len,
                                       depth)
    want_g, want_i = tis.mg_six_frame_batch(*t, model_len=model_len,
                                            depth=depth)
    assert got_g.shape == want_g.shape == (7, 6, 384)
    assert torch.equal(got_g.view(torch.int32), want_g.view(torch.int32))
    assert torch.equal(got_i.view(torch.int32), want_i.view(torch.int32))


@pytest.mark.parametrize("depth", [3, 7])
def test_twin_reads_folded_tables_alike(bank, depth):
    """The engine keeps only the folded prob tables on the card: the twin
    gives the same output on them as on the raw ones."""
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in bank]
    want = tis.mg_six_frame_batch(*t, model_len=12, depth=depth)
    t[1] = icm_cuda.fold_pruned_probs(t[0], t[1])
    t[3] = icm_cuda.fold_pruned_probs(t[2], t[3])
    got = tis.mg_six_frame_batch(*t, model_len=12, depth=depth)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want))


def test_wrapper_on_cpu_ignores_folded(bank):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in bank]
    want = tis.mg_six_frame_batch(*t, model_len=12, depth=7)
    icm_cuda.reset_launches()
    for folded in ((icm_cuda.fold_pruned_probs(t[0], t[1]),
                    icm_cuda.fold_pruned_probs(t[2], t[3])),
                   (torch.zeros(1), torch.zeros(1))):
        got = icm_cuda.mg_six_frame(*t, model_len=12, depth=7, folded=folded)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert icm_cuda.launches == 0
