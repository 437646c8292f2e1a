"""The (dp, tp) device mesh of one process.

Axes:
  dp — data parallel: query batches split by row, each dp row of the mesh
       working its own rows end to end (the reference's only scaling axis
       was file sharding across jobs, ref: kmers-matrix-distance-folder.cc:
       108-116; dp is its in-process replacement).
  tp — table parallel: the signature table split by key owner across the
       devices of a dp row (parallel/sharded_table.owner_of), each device
       probing its own shard; the shards' results are combined on the dp
       row's first device.

A mesh is a grid of torch.devices.  A device may appear more than once
(for example four cells on one card): each cell still holds its own
tensors and makes its own launches.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """devices[d][t]: the device of dp row d and tp column t."""

    devices: tuple

    def __post_init__(self):
        rows = tuple(tuple(torch.device(x) for x in row)
                     for row in self.devices)
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh is a non-empty (dp, tp) grid of "
                             "devices")
        object.__setattr__(self, "devices", rows)

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "tp": len(self.devices[0])}

    @property
    def flat(self) -> list:
        """Every cell's device, row by row (dp-major)."""
        return [d for row in self.devices for d in row]


def local_devices(device_type: str = "cuda") -> list:
    """This process's devices of one type: every CUDA device (raises when
    CUDA is absent), or the one CPU device."""
    if device_type == "cpu":
        return [torch.device("cpu")]
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh was requested but CUDA is not "
                           "available")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, tp: int | None = None,
              devices=None, local: bool = False) -> Mesh:
    """Build the (dp, tp) mesh.

    devices: an explicit device list (overrides the rest; a device may
    repeat); otherwise local_devices().  local: accepted for the JAX
    package's signature; one process's devices are all its devices.
    n_devices: use the first n.  tp defaults to 2 when the device count
    is even and >= 4, else 1, and must divide the device count."""
    del local
    devs = list(devices) if devices is not None else local_devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if tp is None:
        tp = 2 if n % 2 == 0 and n >= 4 else 1
    assert n % tp == 0, (n, tp)
    dp = n // tp
    return Mesh(tuple(tuple(devs[d * tp:(d + 1) * tp]) for d in range(dp)))


def dp_size(mesh: Mesh) -> int:
    return mesh.shape["dp"]


def tp_size(mesh: Mesh) -> int:
    return mesh.shape["tp"]


def dp_cells(mesh: Mesh) -> list:
    """The first device of each dp row, where the row's one-device work
    runs."""
    return [row[0] for row in mesh.devices]
