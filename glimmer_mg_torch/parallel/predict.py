"""Device prediction sharded over the data axis of a mesh of ranks.

Counterpart of the JAX package's ``ops.device_predict.predict_batch_device``
run on inputs sharded along a mesh's ``data`` axis (the data-parallel
prediction of ``__graft_entry__.py:117-161`` and
tests/test_multichip_dryrun.py:99): each rank computes the six-frame scores
of its contiguous shard of the batch with the six-frame kernel
(``ops.icm_cuda.mg_six_frame``) and runs the event DP on them
(``ops.device_predict.predict_batch_device``); only the gene records and
event counts are gathered, in read order. Reads are independent in both,
so the gathered records are those of the unsharded batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import device_predict as dpk, icm_cuda
from . import mesh as pmesh


def predict_batch_sharded(mesh, bank: dpk.DeviceBank, dev_bank: dict, reads,
                          lengths, groups, *, f64: bool = True,
                          subs: bool = False, quals=None):
    """``predict_batch_device`` of a padded read batch, data-sharded.

    reads (B, L) int32, lengths (B,), groups (B,) bank indices and
    ``quals`` (B, L) uint8 (or None) are host numpy arrays, the same on
    every rank; ``dev_bank`` is ``bank_to_device(bank, device)`` on this
    rank's device. The batch is zero-padded to a multiple of the data axis
    (pad rows have length 0). Returns ``predict_batch_device``'s host
    arrays for the B reads, on every rank (``finish_genes`` makes genes
    of them)."""
    device = dev_bank["gene_mip"].device
    n = reads.shape[0]
    reads, lengths, _n = pmesh.pad_batch(mesh, reads, lengths)
    pad = reads.shape[0] - n
    groups = np.pad(np.asarray(groups), (0, pad))
    rows = pmesh.data_rows(mesh, reads.shape[0])
    reads_t, lens_t, grp_t = (
        torch.from_numpy(np.ascontiguousarray(a[rows], np.int32)).to(device)
        for a in (reads, lengths, groups))
    quals_t = None
    if quals is not None:
        quals = np.pad(np.asarray(quals, np.uint8), ((0, pad), (0, 0)),
                       constant_values=255)
        quals_t = torch.from_numpy(np.ascontiguousarray(quals[rows])).to(
            device)
    gene6, ind6 = icm_cuda.mg_six_frame(
        dev_bank["gene_mip"], dev_bank["gene_probs"], dev_bank["indep_mip"],
        dev_bank["indep_probs"], reads_t, lens_t, grp_t,
        model_len=bank.model_len, depth=bank.depth,
        gene_periodicity=bank.periodicity)
    outs = dpk.predict_batch_device(bank, dev_bank, reads_t, lens_t, grp_t,
                                    gene6, ind6, f64=f64, subs=subs,
                                    quals=quals_t)
    gathered = []
    for o in outs:
        t = torch.from_numpy(o.view(np.uint8) if o.dtype == bool else o)
        full = pmesh.materialize(mesh, t.to(device), model_dim=None)[:n]
        gathered.append(full.view(bool) if o.dtype == bool else full)
    return gathered
