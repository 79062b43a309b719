"""Device meshes and batch placement (port of parallel/mesh.py).

The reference's mesh is a JAX ``Mesh`` with a ``data`` axis (batch, corpus
and FSDP sharding) and a ``model`` axis (tensor parallelism), and its
collectives are XLA ops. The port has two kinds of mesh:

  * launched under ``torchrun`` (``torch.distributed`` initialized), a
    mesh over the world: a ``DeviceMesh`` of shape (data, model), one
    device per rank (``cuda:LOCAL_RANK``, or the CPU for gloo). Each rank
    takes its rows of the global batch (``shard_batch``), and the Trainer
    joins the ranks with collectives;
  * otherwise one process drives a list of torch devices, laid out
    row-major over (data, model); an entry may repeat, so four shards of
    one card are ``["cuda:0"] * 4`` and the CPU stands in for the
    reference's virtual CPU devices as ``["cpu"] * 8``. The sharded entry
    points run each shard on its entry and gather the shards' results on
    ``mesh.device`` (the first entry); a step trains the global batch
    there.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from scaling_retriever_tpu_torch.parallel.collectives import Part

@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: tuple           # row-major over (data, model), repeats allowed
    shape: dict
    axis_names: tuple = ("data", "model")
    # the DeviceMesh over the world when launched under torchrun; then
    # ``devices`` is this rank's device, once per rank
    device_mesh: Any = None

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None

    def group(self, axis: str):
        """The process group of this rank's ``axis`` (distributed only)."""
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``; 0 on a single-process mesh."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> bool:
        """More than one distinct device among the entries."""
        return len(set(self.devices)) > 1


def local_devices(device="cuda") -> list:
    """The devices of this process of ``device``'s type: every visible
    card for CUDA, else the one CPU. The ``--use_mesh`` flags build their
    mesh over it."""
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def local_rank_device(device="cuda") -> torch.device:
    """This rank's device of ``device``'s type: ``cuda:LOCAL_RANK`` (the
    rank modulo the visible cards where the launcher set no LOCAL_RANK),
    or the CPU."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    rank = int(os.environ.get(
        "LOCAL_RANK", dist.get_rank() % max(torch.cuda.device_count(), 1)))
    return torch.device("cuda", rank)


def init_distributed(device="cuda") -> torch.device:
    """Under ``torchrun`` (``WORLD_SIZE`` in the environment), join the
    process group it describes (NCCL for ``cuda``, gloo for ``cpu``) if
    this process has not, and return this rank's device; else return
    ``device`` as it is."""
    if "WORLD_SIZE" not in os.environ:
        return torch.device(device)
    if torch.device(device).type != "cuda":
        if not dist.is_initialized():
            dist.init_process_group("gloo")
        return torch.device("cpu")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl", device_id=dev)
    return dev


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None, device="cuda") -> Mesh:
    """A (data, model) mesh. With ``torch.distributed`` initialized and no
    ``devices``, the mesh over the world (one ``device``-type device per
    rank); otherwise a mesh over ``devices`` (default: ``device`` alone),
    in their order. ``data`` defaults to the size // ``model``."""
    if devices is None and dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        world = dist.get_world_size()
        if data is None:
            data = world // model
        if data * model != world:
            raise ValueError(f"mesh ({data}, {model}) over a world of "
                             f"{world}")
        local = local_rank_device(device)
        dm = init_device_mesh(local.type, (data, model),
                              mesh_dim_names=("data", "model"))
        return Mesh((local,) * world, {"data": data, "model": model},
                    device_mesh=dm)
    devices = tuple(torch.device(d) for d in (devices or [device]))
    if data is None:
        data = len(devices) // model
    if data * model != len(devices):
        raise ValueError(f"mesh ({data}, {model}) over {len(devices)} "
                         f"devices")
    return Mesh(devices, {"data": data, "model": model})


def data_sharding(mesh: Mesh) -> torch.device:
    return mesh.device


def replicated(mesh: Mesh) -> torch.device:
    return mesh.device


def local_rows(n: int, mesh: Mesh) -> Optional[tuple]:
    """(first, count) of this rank's rows of a leading dim of ``n`` on a
    distributed mesh: the reference shards a leading dim over ``data``
    when ``data`` divides it and keeps it whole otherwise (then None, as
    on a single-process mesh)."""
    n_data = mesh.shape["data"]
    if not mesh.distributed or n % n_data:
        return None
    per = n // n_data
    return mesh.coordinate("data") * per, per


def rank_part(n: int, mesh: Optional[Mesh]) -> Optional[Part]:
    """This rank's ``Part`` of an encode call over ``n`` global rows; None
    where the call is encoded whole (no mesh, a single-process mesh, or a
    count that ``data`` does not divide)."""
    rows = None if mesh is None else local_rows(n, mesh)
    return None if rows is None else Part(rows[0], rows[1], n)


def to_device(batch, device):
    """Every array or tensor leaf of ``batch`` (nested dicts, lists,
    tuples) as a tensor on ``device``; other leaves as they are."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(to_device(v, device) for v in batch)
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        return torch.as_tensor(batch, device=device)
    return batch


def shard_batch(batch, mesh: Mesh):
    """``batch`` on the mesh's device. On a distributed mesh each array or
    tensor leaf with a leading dim that ``data`` divides keeps this rank's
    rows (rank r of the data axis: rows [r * n/data, (r + 1) * n/data)),
    and any other leaf stays whole, as the reference places a batch; on a
    single-process mesh every leaf stays whole (the step runs the global
    batch)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        rows = local_rows(batch.shape[0], mesh) if batch.ndim else None
        if rows is not None:
            batch = batch[rows[0]:rows[0] + rows[1]]
        return torch.as_tensor(batch, device=mesh.device)
    return batch
