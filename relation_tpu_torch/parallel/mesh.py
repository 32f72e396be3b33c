"""Data parallelism over torch.distributed (counterpart of
relation_tpu/parallel/mesh.py).

The reference's only parallelism is data parallelism with a kvstore
'device' gradient reduce (reference core/DataParallelExecutorGroup.py,
core/module.py:473-518). The JAX package expresses it as a 1-D ``data``
mesh axis: the batch sharded along it, the parameters replicated, and the
gradient all-reduce emitted by XLA. Here each rank is a process with its
own model; the names stay those of the JAX module so a reader finds the
counterpart:

  make_mesh     the process group (rank, world, device, group);
  shard_batch   this rank's rows of a global batch;
  replicated    rank 0's parameters, buffers and train state on every rank;
  all_reduce_mean
                the mean over ranks of gradients or metrics, in place;
  gather_objects
                a picklable object of every rank, on every rank.

There is no model axis (the JAX mesh's ``model`` axis has size 1). The
backend is asked for, never probed: "nccl" when each rank has a GPU of its
own (the default for a CUDA device), "gloo" when the caller asks for it
(the CPU, and several ranks on one card: NCCL refuses two ranks on one
GPU). Gloo reduces and broadcasts CUDA tensors, and gathers CPU objects.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """One rank's view of the data-parallel group. ``group`` is None for a
    one-process mesh (no torch.distributed)."""
    rank: int
    world: int
    device: torch.device
    group: object = None
    backend: str = ""

    @property
    def distributed(self) -> bool:
        return self.world > 1


def make_mesh(n_data: int | None = None, backend: str | None = None,
              device=None, init_method: str | None = None,
              rank: int | None = None, world_size: int | None = None) -> Mesh:
    """The data-parallel group of this process.

    The group comes from, in this order: a process group already
    initialised; ``init_method`` (e.g. ``file:///tmp/x``) with ``rank`` and
    ``world_size`` (or RANK / WORLD_SIZE from the environment); the
    environment torchrun sets (WORLD_SIZE > 1, MASTER_ADDR, ...; "env://").
    Without any of these the mesh is one process (world 1, no group).

    ``device``: default ``cuda:LOCAL_RANK`` for nccl and for a CUDA run, the
    CPU for a gloo run that names no device. ``backend``: default "nccl"
    for a CUDA device, "gloo" for the CPU. ``n_data``, if given, must equal
    the world size."""
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    if device is None:
        device = ("cpu" if backend == "gloo" else f"cuda:{local}")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("backend 'nccl' needs a CUDA device; ask for 'gloo' "
                         "on the CPU")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but "
                               "torch.cuda.is_available() is False")
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if init_method is not None:
            rank = int(os.environ.get("RANK", "0")) if rank is None else rank
            world_size = env_world if world_size is None else world_size
            dist.init_process_group(backend, init_method=init_method,
                                    rank=rank, world_size=world_size)
        elif env_world > 1:
            dist.init_process_group(backend, init_method="env://")
    if not dist.is_initialized():
        mesh = Mesh(rank=0, world=1, device=device)
    else:
        if dist.get_backend() != backend:
            raise ValueError(f"process group on {dist.get_backend()!r}, "
                             f"asked for {backend!r}")
        mesh = Mesh(rank=dist.get_rank(), world=dist.get_world_size(),
                    device=device, group=dist.group.WORLD, backend=backend)
    if n_data is not None and n_data != mesh.world:
        raise ValueError(f"n_data={n_data} but the group has {mesh.world} ranks")
    return mesh


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's rows of a global batch: every entry's leading axis cut in
    ``world`` equal parts, part ``rank`` kept (numpy arrays or tensors)."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % mesh.world:
            raise ValueError(f"shard_batch: {k} has {n} rows for "
                             f"{mesh.world} ranks")
        b = n // mesh.world
        out[k] = v[mesh.rank * b:(mesh.rank + 1) * b]
    return out


def _collective_device(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """NCCL takes CUDA tensors only; gloo takes either."""
    return t.to(mesh.device) if mesh.backend == "nccl" else t


def replicated(mesh: Mesh, model_or_state):
    """Rank 0's parameters and buffers (a model), and for a train state
    (core/trainer.py::TrainState) also its momentum buffers, generator
    state and counts, broadcast to every rank in place. Returns its
    argument."""
    if not mesh.distributed:
        return model_or_state
    state = None if isinstance(model_or_state, torch.nn.Module) else model_or_state
    model = model_or_state if state is None else state.model
    with torch.no_grad():
        tensors = [t for t in model.state_dict().values()]
        if state is not None:
            tensors += [state.trace[k] for k in sorted(state.trace)]
        for t in tensors:
            buf = _collective_device(mesh, t)
            dist.broadcast(buf, 0, group=mesh.group)
            if buf is not t:
                t.copy_(buf)
    if state is not None:
        gen = _collective_device(mesh, state.generator.get_state())
        dist.broadcast(gen, 0, group=mesh.group)
        state.generator.set_state(gen.cpu())
        counts = [(state.step, state.count, state.seed)]
        dist.broadcast_object_list(counts, 0, group=mesh.group)
        state.step, state.count, state.seed = counts[0]
    return model_or_state


def all_reduce_mean(mesh: Mesh, tensors: list) -> list:
    """The mean over ranks of each tensor, in place, in one collective over
    a flat buffer. Returns ``tensors``."""
    if not mesh.distributed or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    buf = _collective_device(mesh, flat)
    dist.all_reduce(buf, group=mesh.group)
    buf = buf.to(flat.device) / mesh.world
    lo = 0
    for t in tensors:
        n = t.numel()
        t.copy_(buf[lo:lo + n].view_as(t))
        lo += n
    return tensors


def gather_objects(mesh: Mesh, obj) -> list:
    """[obj of rank 0, ..., obj of rank world-1] on every rank (pickled CPU
    objects; numpy arrays stay bit-exact)."""
    if not mesh.distributed:
        return [obj]
    out = [None] * mesh.world
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def is_rank0(mesh: Mesh | None) -> bool:
    return mesh is None or mesh.rank == 0
