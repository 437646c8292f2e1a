"""The (dp, tp) device mesh, of one process or spanning processes.

Axes:
  dp — data parallel: query batches split by row, each dp row of the mesh
       working its own rows end to end (the reference's only scaling axis
       was file sharding across jobs, ref: kmers-matrix-distance-folder.cc:
       108-116; dp is its in-process replacement).
  tp — table parallel: the signature table split by key owner across the
       devices of a dp row (parallel/sharded_table.owner_of), each device
       probing its own shard; the shards' results are combined on the dp
       row's first device.

A mesh is a grid of cells, each a torch.device and the rank of the
process that owns it.  A device may appear more than once (for example
four cells on one card): each cell still holds its own tensors and makes
its own launches.  In a multi-process run (parallel/distributed.py) the
mesh spans every rank's local devices in rank order, as jax.devices()
does; each rank then works its own cells only.  The process groups of
the rows that span ranks (the tp combine) and of every rank of the mesh
(the dp sums, the shared rows, the build's exchange) are made here, once,
at construction, in the same order on every rank.
"""

from __future__ import annotations

import dataclasses

import torch

from . import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """devices[d][t]: the device of dp row d and tp column t; ranks[d][t]:
    the process that owns it (default: this process, for every cell)."""

    devices: tuple
    ranks: tuple = None
    groups: dict = dataclasses.field(default=None, compare=False,
                                     repr=False)

    def __post_init__(self):
        rows = tuple(tuple(torch.device(x) for x in row)
                     for row in self.devices)
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh is a non-empty (dp, tp) grid of "
                             "devices")
        me = distributed.process_index()
        ranks = (tuple(tuple(int(r) for r in row) for row in self.ranks)
                 if self.ranks is not None
                 else tuple((me,) * len(row) for row in rows))
        object.__setattr__(self, "devices", rows)
        object.__setattr__(self, "ranks", ranks)
        groups = {}
        if len({r for row in ranks for r in row}) > 1:
            # the spanning rows, then every rank of the mesh: the same
            # order on every rank
            for d, row in enumerate(ranks):
                if len(set(row)) > 1:
                    groups[("row", d)] = distributed.group(row)
            groups["all"] = distributed.group(
                [r for row in ranks for r in row])
        object.__setattr__(self, "groups", groups)

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "tp": len(self.devices[0])}

    @property
    def flat(self) -> list:
        """Every cell's device, row by row (dp-major)."""
        return [d for row in self.devices for d in row]

    @property
    def spans_processes(self) -> bool:
        return bool(self.groups)

    def is_local(self, d: int, t: int) -> bool:
        """Is cell (d, t) this process's?"""
        return self.ranks[d][t] == distributed.process_index()

    def local_columns(self, d: int) -> list:
        """The tp columns of dp row d whose cells are this process's."""
        return [t for t in range(len(self.ranks[d])) if self.is_local(d, t)]

    def local_cells(self) -> list:
        """(d, t, device) of this process's cells, row by row."""
        return [(d, t, dev) for d, row in enumerate(self.devices)
                for t, dev in enumerate(row) if self.is_local(d, t)]

    @property
    def home(self) -> torch.device:
        """This process's first cell's device, where its one-device work
        and the collectives' results land."""
        cells = self.local_cells()
        return cells[0][2] if cells else self.devices[0][0]

    def row_group(self, d: int):
        """The process group of dp row d's ranks, or None when one rank
        owns the whole row."""
        return self.groups.get(("row", d))

    def all_group(self):
        """The process group of every rank of the mesh, or None in one
        process."""
        return self.groups.get("all")


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

    devices: this process's device list (a device may repeat); default
    local_devices().  In a multi-process run the mesh spans every rank's
    list, in rank order (an object all-gather), unless local: then it is
    this process's devices only, the per-process mesh of file-parallel
    runs where each process works its own input slice.  n_devices: use
    the first n.  tp defaults to 2 when the device count is even and
    >= 4, else 1, and must divide the device count."""
    devs = list(devices) if devices is not None else local_devices()
    me = distributed.process_index()
    if not local and distributed.process_count() > 1:
        per_rank = distributed.gather_objects([str(d) for d in devs])
        cells = [(torch.device(d), r) for r, lst in enumerate(per_rank)
                 for d in lst]
    else:
        cells = [(torch.device(d), me) for d in devs]
    if n_devices is not None:
        cells = cells[:n_devices]
    n = len(cells)
    if tp is None:
        tp = 2 if n % 2 == 0 and n >= 4 else 1
    assert n % tp == 0, (n, tp)
    dp = n // tp
    grid = [cells[d * tp:(d + 1) * tp] for d in range(dp)]
    return Mesh(tuple(tuple(c[0] for c in row) for row in grid),
                tuple(tuple(c[1] for c in row) for row in grid))


def dp_size(mesh: Mesh) -> int:
    return mesh.shape["dp"]


def tp_size(mesh: Mesh) -> int:
    return mesh.shape["tp"]


def dp_cells(mesh: Mesh) -> list:
    """The first device of each dp row, where the row's one-device work
    runs."""
    return [row[0] for row in mesh.devices]
