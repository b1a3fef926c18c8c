"""A (data, model) grid of ranks on ``torch.distributed``.

Counterpart of ``glimmer_mg_tpu.parallel.mesh``. JAX drives a mesh of
devices from one process; PyTorch drives one device per process, so here
every rank is a process with one device, and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks with
the axes ``data`` and ``model`` (SURVEY §2.4):

  * ``model``: the ICM bank's rows are split over the ranks of a model
    group; each rank scores its reads against its slice of the bank, and
    gathering the slices is the file merge of the reference's ICM-sharded
    phymm_par mode (scripts/phymm_par.py:146-200);
  * ``data``: reads are split over the ranks of a data group (the
    read-sharded mode, phymm_par.py:210-261); the bank trainer's count
    histograms are summed over it.

``make_mesh`` puts rank r at (r // model, r % model), so one all-gather
over the world brings every block in mesh order (``gather_blocks``).
While the recorder (``utils.observe``) is on, every collective here adds
1 to the counter ``mesh_collectives`` and the bytes a ring sends and
receives on this rank to ``mesh_bytes``: 2 (n - 1) b for an all-gather of
b bytes a rank over n ranks, 4 (n - 1) b / n for an all-reduce of b
bytes, none for a barrier.

The backend follows the device: NCCL for CUDA, gloo for the CPU; only the
caller may name another (``backend=``). gloo's all-gather has no CUDA
path, so a gloo group takes CUDA tensors through host memory; NCCL
gathers them on the card.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils import observe

AXES = ("data", "model")
# any of these in the environment means a launcher (torchrun) started us
_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device) -> torch.device:
    """This rank's own device. ``device`` as given when it is not CUDA or
    names an index (``cuda:0``); a bare ``cuda`` is ``cuda:<local rank>``,
    the launcher's ``LOCAL_RANK`` or else the global rank."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return torch.device("cuda", int(local))
    return torch.device("cuda", dist.get_rank() if dist.is_initialized()
                        else int(os.environ.get("RANK", 0)))


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device,
    backend: str | None = None,
    timeout: datetime.timedelta | None = None,
) -> bool:
    """Join this process to a world of ranks: the port's replacement for the
    reference's Condor process fan-out (scripts/phymm_par.py:268-274).

    With ``coordinator_address`` ("host:port", where rank 0 serves the
    rendezvous), ``num_processes`` and ``process_id``, all three together,
    it joins that world. With none of them it joins the world a launcher
    (torchrun) describes in ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
    ``MASTER_PORT``, and is a no-op returning False when none of these is
    set. ``num_processes <= 1`` is a no-op too, as in the JAX package.
    Returns whether the process group was initialised.

    The backend is ``default_backend(device)`` unless the caller names
    one. On CUDA the rank's device (``rank_device``) becomes the current
    device. Any failure raises; nothing carries on single-process.
    """
    device = torch.device(device)
    given = (coordinator_address, num_processes, process_id)
    if num_processes is not None and num_processes <= 1:
        return False
    kw = {} if timeout is None else {"timeout": timeout}
    if all(v is None for v in given):
        if not any(k in os.environ for k in _LAUNCH_ENV):
            return False
        kw["init_method"] = "env://"
    elif any(v is None for v in given):
        raise ValueError("coordinator_address, num_processes and process_id "
                         "must be given together")
    else:
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} is not in "
                             f"[0, {num_processes})")
        kw.update(init_method=f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
    backend = backend or default_backend(device)
    dist.init_process_group(backend, **kw)
    if device.type == "cuda":
        # an initialised CUDA context keeps init_device_mesh from picking a
        # device of its own
        torch.cuda.set_device(rank_device(device))
        torch.cuda.init()
    return True


def make_mesh(data: int | None = None, model: int | None = None, *,
              device):
    """A (data, model) ``DeviceMesh`` over the initialised world, rank r
    at (r // model, r % model). Defaults: every rank on the data axis.
    Raises ValueError when data x model is not the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(init_distributed)")
    n = dist.get_world_size()
    if data is None and model is None:
        data, model = n, 1
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    return init_device_mesh(torch.device(device).type, (data, model),
                            mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[AXES.index(axis)]


def _axis_slice(mesh, axis: str, n: int) -> slice:
    """This rank's contiguous share of ``n`` rows along ``axis``."""
    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"{n} rows do not split evenly over the {size} "
                         f"ranks of the {axis} axis")
    per = n // size
    i = mesh.get_local_rank(axis)
    return slice(i * per, (i + 1) * per)


def pad_batch(mesh, reads, lengths):
    """Zero-pad a read batch to a multiple of the data axis's size.

    Pad rows have length 0, so they add nothing to training counts or
    scores. Returns (reads, lengths, n_orig); slice results back to
    ``n_orig`` rows after the sharded computation."""
    n = reads.shape[0]
    pad = (-n) % axis_size(mesh, "data")
    if pad:
        reads = np.pad(np.asarray(reads), ((0, pad), (0, 0)))
        lengths = np.pad(np.asarray(lengths), (0, pad))
    return reads, lengths, n


def pad_models(mesh, *arrays):
    """The bank's arrays (models first) padded to a multiple of the model
    axis's size with repeats of model 0. A repeated model scores as model
    0 does and sits after it, so an argmax over the padded scores never
    picks a pad over model 0."""
    pad = (-arrays[0].shape[0]) % axis_size(mesh, "model")
    return tuple(np.concatenate([a, np.repeat(a[:1], pad, axis=0)])
                 if pad else a for a in arrays)


def data_rows(mesh, n: int) -> slice:
    """This rank's rows of a batch of ``n`` (a multiple of the data axis)."""
    return _axis_slice(mesh, "data", n)


def model_rows(mesh, m: int) -> slice:
    """This rank's models of a bank of ``m`` (a multiple of the model
    axis)."""
    return _axis_slice(mesh, "model", m)


def shard_reads(mesh, reads, lengths, device):
    """This rank's contiguous slice along ``data`` of padded numpy
    reads/lengths, on ``device``. The batch must divide by the data axis
    (``pad_batch``)."""
    rows = data_rows(mesh, reads.shape[0])
    return tuple(torch.from_numpy(np.ascontiguousarray(a[rows])).to(device)
                 for a in (reads, lengths))


def shard_bank(mesh, *arrays, device):
    """This rank's contiguous slice along ``model`` of each numpy bank
    array (bank rows, or the packed bank-walk tables that
    ``icm_cuda.pack_tables`` makes of them: it packs model by model), on
    ``device``. The bank must divide by the model axis (``pad_models``)."""
    rows = model_rows(mesh, arrays[0].shape[0])
    return tuple(torch.from_numpy(np.ascontiguousarray(a[rows])).to(device)
                 for a in arrays)


def _staged(x, group):
    """``x`` where the group's backend can take it: gloo in host memory."""
    return x.cpu() if dist.get_backend(group) == "gloo" else x


def _count(nbytes: int) -> None:
    if observe.enabled():
        observe.count("mesh_collectives")
        observe.count("mesh_bytes", nbytes)


def _comm_device() -> torch.device:
    """Where the world's backend takes tensors: this rank's card for NCCL,
    host memory otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather(x, group=None) -> list:
    """Every group rank's ``x`` (all the same shape), in group-rank order,
    where the backend takes them."""
    n = dist.get_world_size(group)
    x = _staged(x, group).contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    _count(2 * (n - 1) * x.numel() * x.element_size())
    return parts


def _gather(x, group, dim: int = 0):
    """Concatenation along ``dim`` of every group rank's ``x`` (all the
    same shape), in group-rank order: the mesh coordinate's order."""
    if dist.get_world_size(group) == 1:
        return x
    return torch.cat(_all_gather(x, group), dim=dim)


def all_reduce_sum(x, group):
    """The elementwise sum of every group rank's ``x``, on ``x``'s device."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    y = _staged(x, group)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    _count(4 * (n - 1) * y.numel() * y.element_size() // n)
    return y if y is x else y.to(x.device)


def gather_blocks(mesh, block, rows=None):
    """The whole matrix of every rank's block, in global order, on
    ``block``'s device: one all-gather over the world (span
    ``mesh.gather``).

    ``block`` is this rank's (reads x models) block: the rows of its data
    coordinate's reads and the columns of its model slice. ``rows`` gives
    the reads of each data coordinate, which may differ (the blocks are
    padded to the most for the gather); without it every block has as
    many rows as this one."""
    data, model = mesh.shape
    if data * model == 1:
        return block
    rows = [block.shape[0]] * data if rows is None else [int(r) for r in rows]
    pad = max(rows) - block.shape[0]
    with observe.span("mesh.gather", rows=max(rows)):
        if pad:
            block = torch.cat([block, block.new_zeros(
                (pad,) + tuple(block.shape[1:]))])
        parts = _all_gather(block)
        whole = torch.cat([torch.cat(parts[i * model:(i + 1) * model],
                                     dim=1)[:rows[i]] for i in range(data)])
        return whole.to(block.device)


def exchange(values) -> np.ndarray:
    """(world, k) int64: every rank's ``values`` (k integers), in rank
    order; one all-gather (span ``mesh.offsets``)."""
    with observe.span("mesh.offsets"):
        x = torch.tensor([int(v) for v in values], dtype=torch.int64)
        return torch.stack(_all_gather(x.to(_comm_device()))).cpu().numpy()


def gather_bytes(data: bytes, sizes) -> list[bytes]:
    """Every rank's ``data``, in rank order, given each rank's size
    (``sizes``, as ``exchange`` gives them); one all-gather (span
    ``mesh.gather``)."""
    sizes = [int(n) for n in sizes]
    with observe.span("mesh.gather", bytes=sum(sizes)):
        x = np.zeros(max(sizes), np.uint8)
        x[:len(data)] = np.frombuffer(data, np.uint8)
        parts = _all_gather(torch.from_numpy(x).to(_comm_device()))
        return [p[:n].cpu().numpy().tobytes() for p, n in zip(parts, sizes)]


def materialize(mesh, x, model_dim: int | None = 1) -> np.ndarray:
    """The whole array of a sharded block as host numpy, on every rank.

    ``x`` is this rank's block: rows (dim 0) split evenly along ``data``
    and, when ``model_dim`` is 1, columns split along ``model``
    (``gather_blocks``: the reference's file-merge join,
    scripts/phymm_par.py:410-474, as one collective); with ``model_dim``
    None, the data group's blocks are gathered. Without a mesh it is
    ``x`` as numpy."""
    if mesh is not None:
        if model_dim not in (1, None):
            raise ValueError(f"model_dim must be 1 or None, not {model_dim}")
        x = (gather_blocks(mesh, x) if model_dim == 1
             else _gather(x, mesh.get_group("data"), 0))
    return x.cpu().numpy()


def is_output_process() -> bool:
    """True on the process that writes shared files: rank 0, or the only
    process when the world is not initialised."""
    return not dist.is_initialized() or dist.get_rank() == 0


def one_host() -> bool:
    """True when every rank of the world runs on this host, as the
    launcher says (``LOCAL_WORLD_SIZE`` equal to the world's size)."""
    return (dist.is_initialized() and os.environ.get("LOCAL_WORLD_SIZE")
            == str(dist.get_world_size()))


def barrier() -> None:
    """Wait for every rank of the world (no-op without one); span
    ``mesh.barrier``."""
    if dist.is_initialized():
        with observe.span("mesh.barrier"):
            dist.barrier()
            _count(0)


def destroy() -> None:
    """Leave the world, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
