"""Scimm/PhyScimm-equivalent clustering: classification-seeded iterative EM.

Counterpart of ``glimmer_mg_tpu.pipeline.scimm``, on a chosen device or
over a (data, model) mesh of ranks. The reference invokes the external
Scimm package (a missing large blob; scimm-0.3.0.tar.gz): physcimm.py
initializes clusters from the Phymm best-hit table at a taxonomic level
(dropping clusters below a bp fraction), then iterates: train an IMM per
cluster (build-icm), score every read against every cluster IMM
(simple-score), reassign reads to the argmax cluster (SURVEY P12;
artifacts cluster-<k>.fa / cluster-<k>.icm / icm-<k>.scores.tmp in
sample-run). Exact parity is impossible (Scimm is stochastic per the
reference manual, docs/notes.tex:249-253); this module reconstructs the
algorithm deterministically, with two routes for the EM:

  * the device EM (``_device_em``): the whole cluster bank trained at once
    by ``ops.icm_train_device.train_icm_bank``, the reads scored against it
    by the bank-walk kernel over its 16-bit tables (``icm_cuda.
    pack_tables`` + ``parallel.classify.classify_step_kernel``: the CUDA
    kernel on a CUDA device, its twin on the CPU), as the JAX package does
    on the TPU; with a mesh, the reads sharded over ``data`` (the
    trainer's counts summed over the data group) and the cluster bank over
    ``model`` (``classify_step_kernel_sharded``);
  * the host EM: the exact host trainer (``models.icm_train``) per cluster
    and the exact f32 walk (``classify_step``) on ``device``.

``init_clusters_from_results``, ``_train_cluster_icms``, ``_bank_to_icms``
and ``write_cluster_artifacts`` are copies of the JAX package's: its module
imports JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..engine.glimmer_mg import _check_device
from ..models import dna, icm as icm_mod, icm_train
from ..ops import icm_cuda, icm_score, icm_train_device
from ..parallel import classify as pclassify
from ..parallel import mesh as pmesh


def init_clusters_from_results(results_file, read_ids, taxonomy=None,
                               taxlevel_index: int = 1, minbp_pct: float = 0.01,
                               read_lengths=None):
    """Seed clusters by grouping reads on a taxonomy rank of their best hit.

    ``taxlevel_index``: 0=genus, 1=family, ... over the results columns.
    Falls back to the strain name when the rank column is blank. Clusters
    holding < minbp_pct of total bp are dropped (their reads go to the
    biggest cluster).
    """
    best = {}
    with open(results_file) as fh:
        header = fh.readline()
        for line in fh:
            toks = line.rstrip("\n").split("\t")
            rid = toks[0]
            rank = ""
            if len(toks) > 3 + taxlevel_index:
                rank = toks[3 + taxlevel_index]
            best[rid] = rank if rank else toks[1]

    groups: dict[str, list[int]] = {}
    for i, rid in enumerate(read_ids):
        groups.setdefault(best.get(rid, ""), []).append(i)

    if read_lengths is None:
        read_lengths = np.ones(len(read_ids))
    total_bp = float(np.sum(read_lengths))
    keep = {k: v for k, v in groups.items()
            if sum(read_lengths[i] for i in v) >= minbp_pct * total_bp}
    if not keep:
        keep = {max(groups, key=lambda k: len(groups[k])): sum(groups.values(), [])}
    biggest = max(keep, key=lambda k: len(keep[k]))
    assign = np.zeros(len(read_ids), dtype=np.int32)
    names = sorted(keep)
    for ci, name in enumerate(names):
        for i in keep[name]:
            assign[i] = ci
    for name, members in groups.items():
        if name not in keep:
            for i in members:
                assign[i] = names.index(biggest)
    return assign, names


def _train_cluster_icms(seqs, assign, n_clusters, min_bp=500):
    """Host trainer per cluster (bit-exact path); tiny clusters get a
    uniform placeholder that scores poorly."""
    icms = []
    for c in range(n_clusters):
        strings = [seqs[i].lower() for i in range(len(seqs)) if assign[i] == c]
        bp = sum(len(s) for s in strings)
        if bp >= min_bp:
            icms.append(icm_train.train_icm([dna.encode(s) for s in strings]))
        else:
            m = icm_mod.ICM.empty()
            m.probs[:] = np.float32(np.log(0.25))
            m.mip[:, 0] = -1
            m.mip[:, 1:] = -2
            icms.append(m)
    return icms


def _bank_to_icms(mip, probs, model_len=12, depth=7) -> list:
    """Device-trained bank tensors -> host ICM objects (for artifacts)."""
    mip = np.asarray(mip)
    probs = np.asarray(probs, dtype=np.float32)
    return [
        icm_mod.ICM(model_len, depth, mip.shape[1], mip[i].astype(np.int16),
                    probs[i])
        for i in range(mip.shape[0])
    ]


def _device_em(reads, lengths, init_assign, n_clusters, max_iters, device,
               model_len=12, depth=7, mesh=None):
    """EM with per-cluster retraining on ``device``
    (``ops.icm_train_device``) and classification through the bank-walk
    kernel over the retrained bank's 16-bit tables. Trains at the top of
    every iteration and once more after the last; stops when no read
    changes cluster. Returns (assign, cluster ICMs, scores (n_reads,
    n_clusters) of the last scoring).

    With ``mesh`` the reads are zero-padded to the data axis (pad rows
    have length 0: no counts, no scores) and sharded over it, the trainer
    sums its counts over the data group, and the retrained bank is padded
    to the model axis and sharded over it for the walk; the gathered
    scores are sliced back. Every rank returns the same result."""
    n_reads = reads.shape[0]
    group = None
    if mesh is None:
        reads_t = torch.from_numpy(reads).to(device)
        lengths_t = torch.from_numpy(lengths).to(device)
        mine = slice(None)
    else:
        reads, lengths, n_reads = pmesh.pad_batch(mesh, reads, lengths)
        reads_t, lengths_t = pmesh.shard_reads(mesh, reads, lengths, device)
        mine = pmesh.data_rows(mesh, reads.shape[0])
        group = mesh.get_group("data")
    assign = np.asarray(init_assign, dtype=np.int32).copy()
    scores = mip = probs = None
    for it in range(max_iters + 1):
        onehot = np.zeros((reads.shape[0], n_clusters), np.float32)
        onehot[np.arange(len(assign)), assign] = 1.0  # pad rows stay zero
        mip, probs = icm_train_device.train_icm_bank(
            reads_t, lengths_t, torch.from_numpy(onehot[mine]).to(device),
            n_models=n_clusters, model_len=model_len, depth=depth,
            data_group=group,
        )
        if it == max_iters:
            break
        if mesh is None:
            tabs = icm_cuda.pack_tables(mip.cpu().numpy(),
                                        probs.cpu().numpy(), depth=depth)
            scores, _ = pclassify.classify_step_kernel(
                *(torch.from_numpy(t).to(device) for t in tabs), reads_t,
                lengths_t, model_len, depth)
            scores = scores.cpu().numpy()
        else:
            tabs = icm_cuda.pack_tables(*pmesh.pad_models(
                mesh, mip.cpu().numpy(), probs.cpu().numpy()), depth=depth)
            scores, _ = pclassify.classify_step_kernel_sharded(
                mesh, *pmesh.shard_bank(mesh, *tabs, device=device), reads_t,
                lengths_t, model_len, depth)
            scores = scores[:n_reads, :n_clusters]
        new_assign = np.argmax(scores, axis=1).astype(np.int32)
        if np.array_equal(new_assign, assign):
            break
        assign = new_assign
    return (assign, _bank_to_icms(mip.cpu().numpy(), probs.cpu().numpy(),
                                  model_len, depth), scores)


def scimm_cluster(
    seqs: list[str],
    init_assign: np.ndarray,
    n_clusters: int,
    max_iters: int = 10,
    use_device: bool | None = None,
    *,
    device,
    mesh=None,
    model_len: int = 12,
    depth: int = 7,
):
    """Iterative EM clustering on ``device``; returns (assign,
    cluster_icms, scores).

    ``use_device`` picks the route: the device EM (bank trainer + bank-walk
    kernel) or the bit-exact host trainer with the exact walk. ``None``
    picks the device EM on a CUDA device, as the JAX package picks it on
    its accelerator. ``mesh`` shards the device EM over a (data, model)
    mesh of ranks (the device route only, as in the JAX package)."""
    device = _check_device(device)
    if use_device is None:
        use_device = device.type == "cuda"
    assign = np.asarray(init_assign, dtype=np.int32).copy()
    length = max((len(s) for s in seqs), default=3)
    length += (-length) % 3
    reads, lengths = pclassify.pad_reads([s.lower() for s in seqs], length=length)

    if use_device:
        return _device_em(reads, lengths, assign, n_clusters, max_iters,
                          device, model_len, depth, mesh)

    reads_t = torch.from_numpy(reads).to(device)
    lengths_t = torch.from_numpy(lengths).to(device)
    scores = None
    for it in range(max_iters):
        icms = _train_cluster_icms(seqs, assign, n_clusters)
        mip, probs = (torch.from_numpy(t).to(device)
                      for t in icm_score.stack_bank(icms))
        scores, best = pclassify.classify_step(mip, probs, reads_t, lengths_t,
                                               12, 7)
        scores = scores.cpu().numpy()
        new_assign = np.argmax(scores, axis=1).astype(np.int32)
        if np.array_equal(new_assign, assign):
            assign = new_assign
            break
        assign = new_assign
    icms = _train_cluster_icms(seqs, assign, n_clusters)
    return assign, icms, scores


def write_cluster_artifacts(out_dir, read_recs, assign, icms, scores) -> None:
    """cluster-<k>.fa, cluster-<k>.icm, icm-<k>.scores.tmp (the files
    glimmer-mg.py consumes at :127-131 and :343-348)."""
    from ..io.fasta import write_fasta

    n_clusters = len(icms)
    for c in range(n_clusters):
        members = [read_recs[i] for i in range(len(read_recs)) if assign[i] == c]
        write_fasta(os.path.join(out_dir, f"cluster-{c}.fa"), members, width=60)
        icm_mod.write_icm(icms[c], os.path.join(out_dir, f"cluster-{c}.icm"))
        with open(os.path.join(out_dir, f"icm-{c}.scores.tmp"), "w") as fh:
            for i, (h, _) in enumerate(read_recs):
                fh.write("%-20s\t%10.4f\n" % (h.split()[0], scores[i, c]))
