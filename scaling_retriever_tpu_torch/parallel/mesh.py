"""Device meshes and batch placement (port of parallel/mesh.py).

The reference's mesh is a JAX ``Mesh`` with a ``data`` axis (batch, corpus
and FSDP sharding) and a ``model`` axis (tensor parallelism), and its
collectives are XLA ops. Here one process drives a mesh that is a list of
torch devices, laid out row-major over (data, model); an entry may repeat,
so four shards of one card are ``["cuda:0"] * 4`` and the CPU stands in
for the reference's virtual CPU devices as ``["cpu"] * 8``. The sharded
entry points run each shard on its entry and gather the shards' results
on ``mesh.device`` (the first entry).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: tuple           # row-major over (data, model), repeats allowed
    shape: dict
    axis_names: tuple = ("data", "model")

    @property
    def device(self) -> torch.device:
        return self.devices[0]

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


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None, device="cuda") -> Mesh:
    """A (data, model) mesh over ``devices`` (default: ``device`` alone),
    in their order; ``data`` defaults to ``len(devices) // model``."""
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


def shard_batch(batch, mesh: Mesh):
    """Every array or tensor leaf of ``batch`` (nested dicts, lists,
    tuples) moved to the mesh's first device, where the step runs the
    global batch; other leaves as they are."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        return torch.as_tensor(batch, device=mesh.device)
    return batch
