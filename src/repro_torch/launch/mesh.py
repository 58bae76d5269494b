"""The port's meshes (port of `repro/launch/mesh.py`).

The expert-parallel serving mesh (`make_ep_mesh`): the reference builds a
1-D JAX mesh named "model" over the first `ep_shards` devices, and one
process runs the expert FFN over it in `shard_map`. The port's mesh is the
list of the shards' devices; one process drives every shard, one expert-FFN
launch a shard. Every shard lives on one device: shards on distinct cards
(peer copies of the partials) wait for a host with more than one GPU
(ROADMAP A14(c)).

The production meshes of the dry run (`make_production_mesh`, `make_mesh`)
are shapes only: axis names and extents, with the same
`.shape` and `.axis_names` as `EPMesh`, which is all the sharding policy and
the fake-tensor dry run read. Nothing is placed on them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class EPMesh:
    """A 1-D mesh: one device a shard along `axis_names[0]`."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("model",)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("an expert-parallel mesh needs at least one shard")
        if len(set(self.devices)) > 1:
            raise NotImplementedError(
                f"expert-parallel shards on distinct devices ({sorted(map(str, set(self.devices)))}) "
                "are ROADMAP A14(c); every shard must live on one device")

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def device(self) -> torch.device:
        """The one device every shard lives on."""
        return self.devices[0]


@dataclass(frozen=True)
class Mesh:
    """A shape-only mesh: `extents[i]` devices along `axis_names[i]`."""

    extents: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.extents) != len(self.axis_names):
            raise ValueError(f"{len(self.extents)} extents for axes {self.axis_names}")
        if any(n < 1 for n in self.extents):
            raise ValueError(f"mesh extents must be >= 1, got {self.extents}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.extents))

    @property
    def size(self) -> int:
        n = 1
        for e in self.extents:
            n *= e
        return n


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """One pod, (16, 16) over ("data", "model"), or two, (2, 16, 16) over
    ("pod", "data", "model"): the `pod` axis is pure data parallelism."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    """Any mesh (the tests use small ones)."""
    return Mesh(tuple(shape), tuple(axes))


def make_ep_mesh(ep_shards: int, device: DeviceLike = None,
                 devices: Optional[Sequence[DeviceLike]] = None) -> EPMesh:
    """A 1-D "model" mesh of `ep_shards` shards, all on `device` (CUDA
    unless asked otherwise). `devices` names one device a shard instead;
    distinct devices raise `NotImplementedError` (ROADMAP A14(c))."""
    if ep_shards < 1:
        raise ValueError(f"ep_shards must be >= 1, got {ep_shards}")
    if devices is None:
        devices = [device] * ep_shards
    if len(devices) != ep_shards:
        raise ValueError(f"{len(devices)} devices for {ep_shards} shards")
    return EPMesh(tuple(resolve_device(d) for d in devices))
