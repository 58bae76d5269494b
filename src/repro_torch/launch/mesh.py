"""The expert-parallel serving mesh (port of `repro/launch/mesh.py::make_ep_mesh`).

The reference builds a 1-D JAX mesh named "model" over the first
`ep_shards` devices, and one process runs the expert FFN over it in
`shard_map`. The port's mesh is the list of the shards' devices; one
process drives every shard, one expert-FFN launch a shard. Every shard
lives on one device: shards on distinct cards (peer copies of the
partials) wait for a host with more than one GPU (ROADMAP A14(c)).
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
