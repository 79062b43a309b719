"""Device placement on one card, under the names of parallel/mesh.py.

The reference's mesh has a ``data`` axis (batch and FSDP sharding) and a
``model`` axis. The port runs on one card: a mesh is that card, both axes
of size 1, and ``shard_batch`` moves a batch onto it. Meshes over several
cards, and the FSDP and tensor-parallel placements of
``parallel/partitioning.py``, are ROADMAP A10.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: tuple
    shape: dict
    axis_names: tuple = ("data", "model")

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None, device="cuda") -> Mesh:
    """A (data, model) mesh over ``devices`` (default: ``device``); one
    device only."""
    devices = tuple(torch.device(d) for d in (devices or [device]))
    if data is None:
        data = len(devices) // model
    if data * model != len(devices):
        raise ValueError(f"mesh ({data}, {model}) over {len(devices)} "
                         f"devices")
    if len(devices) != 1:
        raise NotImplementedError("a mesh over several cards is not ported "
                                  "yet (ROADMAP A10)")
    return Mesh(devices, {"data": data, "model": model})


def data_sharding(mesh: Mesh) -> torch.device:
    return mesh.device


def replicated(mesh: Mesh) -> torch.device:
    return mesh.device


def shard_batch(batch, mesh: Mesh):
    """Every array or tensor leaf of ``batch`` (nested dicts, lists,
    tuples) moved to the mesh's card; other leaves as they are."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        return torch.as_tensor(batch, device=mesh.device)
    return batch
