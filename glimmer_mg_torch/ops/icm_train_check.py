"""Hold two trainings of the same reads by ``icm_train_device.
train_icm_bank`` (the CPU's and the card's, each run with a ``record``)
to each other.

The counts are exact integer sums on both devices, so a node whose
ancestors chose the same context positions sees the same counts in both.
Its float math differs only through ``log``: each device's is within an
ulp, and the 16 pair terms of a position's mutual information are summed
in one order on both. So each position's mutual information may differ by
a few ulps of the sum of its terms' magnitudes, and a ``mip`` node may
differ only where that moves a decision of ``_select_positions`` (the
``>=`` or the right-bias ``best / 1.03``): a near-tie.
"""

from __future__ import annotations

import torch

from .icm_train_device import _select_positions

F32_EPS = 2.0 ** -23
MI_REL = 4 * F32_EPS  # x the sum of |p log r| over a position's 16 terms
PROB_REL = 4 * F32_EPS  # relative, between two logged probs


def _close(a, b, rel):
    """|a - b| <= rel * max(|a|, |b|) elementwise (equal values pass)."""
    return (a == b) | ((a - b).abs() <= rel * torch.maximum(a.abs(), b.abs()))


def tie_nodes(mip_a, probs_a, rec_a, mip_b, probs_b, rec_b, *,
              mi_rel=MI_REL, prob_rel=PROB_REL):
    """Hold two trainings of the same reads to each other.

    At every node whose ancestors agree, the sample sizes must be equal and
    each position's mutual information within ``mi_rel`` x the larger of
    the two recorded term magnitudes (``"mag"``). Its ``mip`` must be
    equal, except at a near-tie: there each training's choice must still
    be what ``_select_positions`` makes of its own recorded MI, so only an
    MI rounding within that bound moved the decision. Nodes under a
    near-tie see other counts and are not compared. Logged probs of
    compared nodes must be within ``prob_rel`` relative (4 f32 ulps by
    default: the two ``log``s are each within an ulp).

    Returns (near-ties, worst): the near-ties as dicts (model, frame, node,
    the two chosen positions and both trainings' MI at each), and the
    largest MI difference over the compared positions in units of
    ``F32_EPS`` x their term magnitude. Raises AssertionError on any other
    difference.
    """
    mip_a, mip_b = mip_a.cpu(), mip_b.cpu()
    compared = torch.ones(mip_a.shape, dtype=torch.bool)
    ties, worst = [], 0.0
    first, width = 0, 1
    for level, (mi_a, mi_b, m_a, m_b, s_a, s_b) in enumerate(zip(
            rec_a["mi"], rec_b["mi"], rec_a["mag"], rec_b["mag"],
            rec_a["sums"], rec_b["sums"])):
        nodes = torch.arange(first, first + width)
        if level:
            parents = (nodes - 1) // 4
            compared[:, :, nodes] = (
                compared[:, :, parents]
                & (mip_a[:, :, parents] == mip_b[:, :, parents]))
        mi_a, mi_b = mi_a.cpu(), mi_b.cpu()
        s_a, s_b = s_a.cpu(), s_b.cpu()
        alive = compared[:, :, nodes] & (mip_a[:, :, nodes] >= -1)
        if not torch.equal(s_a[alive], s_b[alive]):
            raise AssertionError(f"level {level}: sample sizes differ")
        gap = (mi_a - mi_b).abs()[alive].double().reshape(-1)
        mag = torch.maximum(m_a.cpu(), m_b.cpu())[alive].double().reshape(-1)
        if bool((gap > mi_rel * mag).any()):
            at = (gap - mi_rel * mag).argmax()
            raise AssertionError(
                f"level {level}: mutual information differs by "
                f"{float(gap[at]):.3e}, over {mi_rel / F32_EPS:g} x 2^-23 x "
                f"its terms' magnitude {float(mag[at]):.3e}")
        nz = mag > 0
        if bool(nz.any()):
            worst = max(worst, float((gap[nz] / mag[nz]).max()) / F32_EPS)
        diff = alive & (mip_a[:, :, nodes] != mip_b[:, :, nodes])
        for mk, fk, k in diff.nonzero().tolist():
            node = first + k
            pa, pb = int(mip_a[mk, fk, node]), int(mip_b[mk, fk, node])
            own = [int(_select_positions(mi[mk, fk, k][None],
                                         s[mk, fk, k][None],
                                         stop_check=level > 0)[0])
                   for mi, s in ((mi_a, s_a), (mi_b, s_b))]
            if own != [pa, pb]:
                raise AssertionError(
                    f"model {mk} frame {fk} node {node}: mip {pa} vs {pb} "
                    f"is not a mutual-information near-tie")
            ties.append({
                "model": mk, "frame": fk, "node": node, "mip": (pa, pb),
                "mi_a": [float(mi_a[mk, fk, k, q]) for q in (pa, pb)
                         if q >= 0],
                "mi_b": [float(mi_b[mk, fk, k, q]) for q in (pa, pb)
                         if q >= 0]})
        first += width
        width *= 4
    both = compared & (mip_a >= -1)
    pa, pb = probs_a.cpu()[both], probs_b.cpu()[both]
    if not bool(_close(pa, pb, prob_rel).all()):
        raise AssertionError(f"logged probs differ by up to "
                             f"{float((pa - pb).abs().max()):.3e}")
    return ties, worst
