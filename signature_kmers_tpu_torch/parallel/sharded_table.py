"""Table-parallel (tp) linear-probing table.

Keys are partitioned by the top bits of their slot hash (owner_of) into
independent per-shard open-addressing tables of one common size, stacked
(n_shards, S) on the host as the JAX package stacks them.  On the mesh
each shard is two row arrays (to_mesh: ops/probe.linear_rows, a slot's
two key words in one 8-byte row, its three value words in a 16-byte
one), which kernel L2 (ops/probe.probe_table) walks.  Every dp row of
the mesh probes its own queries against every shard, one shard per
device of the row; since a key lives in one shard only, at most one
shard reports a hit for a query and writes nonzero words, so the row's
results combine exactly by OR on its first device (the JAX package
combines them with a psum over tp).  Where a row spans processes, each
rank probes its own cells' shards and the row sums their int32 views
over its process group (NCCL has no bitwise OR; the sum is exact for
the same reason).

This replaces the reference's always-fully-resident table
(ref: cmph_kmer.h:71-83; the reference has no table sharding at all).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.config import TableConfig
from ..ops import hashing, probe as probe_ops
from . import distributed
from ..table.kmer_table import KmerTable


def owner_of(hi, lo, n_shards: int) -> np.ndarray:
    """Key-owner shard = the top log2(n_shards) bits of the slot hash."""
    h = hashing.hash_kmer(hi, lo)
    if n_shards == 1:
        return np.zeros_like(h, dtype=np.uint32)
    bits = int(n_shards).bit_length() - 1
    return h >> np.uint32(32 - bits)


def combine_tp(parts, device) -> tuple:
    """The tp shards' outputs of one dp row (a tuple of tensors each)
    combined on ``device``: bool masks and value words alike by OR, exact
    because at most one shard found the key and the others wrote zeros."""
    return tuple(functools.reduce(torch.bitwise_or,
                                  (p[k].to(device) for p in parts))
                 for k in range(len(parts[0])))


def combine_row(mesh, d: int, parts, device) -> tuple:
    """Dp row d's combine: this process's cells' outputs (parts) by OR on
    ``device``, then, when the row spans processes, the sum of the ranks'
    int32 views over the row's group (all_reduce_sum; the JAX package's
    psum over tp), so every rank of the row holds the row's result."""
    local = combine_tp(parts, device)
    g = mesh.row_group(d)
    if g is None:
        return local
    x = distributed.all_reduce_sum(
        torch.stack([p.to(torch.int32) for p in local]), g)
    return tuple(x[k] != 0 if p.dtype == torch.bool else x[k].to(p.dtype)
                 for k, p in enumerate(local))


def share_rows(mesh, rows: dict, device) -> dict:
    """Each dp row's result ({d: tensor}, held by the rank of the row's
    first cell) on every rank of a process-spanning mesh, on ``device``:
    the JAX package's scatter + psum over dp, which leaves the result
    replicated.  One process: rows as they are."""
    g = mesh.all_group()
    if g is None:
        return rows
    owned = {d: x for d, x in rows.items() if mesh.is_local(d, 0)}
    return distributed.share(owned, g, device)


def split_rows(n: int, ndp: int) -> list:
    """(start, end) of each dp row's share of n rows: contiguous blocks of
    ceil(n / ndp), as a dp-sharded array of n rows padded to a multiple of
    ndp splits (the last blocks may be short or empty)."""
    step = -(-n // ndp) if n else 0
    return [(min(d * step, n), min((d + 1) * step, n)) for d in range(ndp)]


@dataclasses.dataclass
class ShardedKmerTable:
    """Stacked per-shard tables: arrays of shape (n_shards, S_shard)."""

    key_hi: np.ndarray
    key_lo: np.ndarray
    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    n_items: int
    max_probes: int

    @property
    def n_shards(self) -> int:
        return int(self.key_hi.shape[0])

    @staticmethod
    def build(hi, lo, v0, v1, v2, n_shards: int,
              config: TableConfig = TableConfig()) -> "ShardedKmerTable":
        assert n_shards & (n_shards - 1) == 0, "n_shards must be a power of 2"
        hi = np.asarray(hi, dtype=np.uint32)
        lo = np.asarray(lo, dtype=np.uint32)
        v0, v1, v2 = (np.asarray(v) for v in (v0, v1, v2))
        owner = owner_of(hi, lo, n_shards)
        counts = np.bincount(owner, minlength=n_shards)
        shard_size = max(config.min_size, hashing.next_pow2(
            int(counts.max() / config.load_factor) + 1))
        sub_cfg = dataclasses.replace(config, min_size=shard_size)
        parts = []
        for s in range(n_shards):
            m = owner == s
            t = KmerTable.build(hi[m], lo[m], v0[m], v1[m], v2[m], sub_cfg)
            assert t.size == shard_size
            parts.append(t)
        return ShardedKmerTable(
            *(np.stack([getattr(t, k) for t in parts])
              for k in ("key_hi", "key_lo", "v0", "v1", "v2")),
            n_items=int(hi.shape[0]),
            max_probes=max([1] + [t.max_probes for t in parts]))

    @staticmethod
    def from_table(table, n_shards: int,
                   config: TableConfig = TableConfig()) -> "ShardedKmerTable":
        return ShardedKmerTable.build(*table.occupied(), n_shards, config)

    def to_mesh(self, mesh) -> list:
        """The shards on the mesh: cells[d][t] = shard t's device rows
        (ops/probe.linear_rows: keys (S, 2) and vals (S, 4) int32) on
        device (d, t); shard t goes to every device of tp column t, and
        only this process's cells are filled (None elsewhere).  The mesh's
        tp size must be n_shards."""
        if mesh.shape["tp"] != self.n_shards:
            raise ValueError(f"a table of {self.n_shards} shards on a mesh "
                             f"of tp {mesh.shape['tp']}")
        words = (self.key_hi, self.key_lo, self.v0, self.v1, self.v2)
        rows = {}

        def shard_rows(t):  # built on the host once per shard
            if t not in rows:
                rows[t] = probe_ops.linear_rows(*(
                    torch.from_numpy(np.ascontiguousarray(w[t])
                                     .view(np.int32)) for w in words))
            return rows[t]

        return [[tuple(x.to(dev) for x in shard_rows(t))
                 if mesh.is_local(d, t) else None
                 for t, dev in enumerate(row)]
                for d, row in enumerate(mesh.devices)]


def probe_sharded(mesh, cells, qhi, qlo, max_probes: int):
    """Probe a tp-sharded table with dp-split flat queries.

    cells: ShardedKmerTable.to_mesh(mesh); qhi, qlo: (M,) int32 tensors
    (bit containers of the uint32 words), the same on every rank.  Row d
    of the mesh takes the d-th contiguous block of the queries
    (split_rows), each of its (local) devices probes the block against
    its shard's rows (ops/probe.probe_table), and the row's results are
    combined (combine_row).  -> (found bool, r0, r1, r2 int32), (M,)
    each, on this process's first cell, in query order."""
    out_dev = mesh.home
    rows = {}
    for d, ((a, b), row, cell_row) in enumerate(zip(
            split_rows(qhi.shape[0], mesh.shape["dp"]), mesh.devices,
            cells)):
        mine = mesh.local_columns(d)
        if a == b or not mine:
            continue
        parts = [probe_ops.probe_table(*cell_row[t], qhi[a:b].to(row[t]),
                                       qlo[a:b].to(row[t]), max_probes)
                 for t in mine]
        rows[d] = torch.stack([x.to(torch.int32) for x in
                               combine_row(mesh, d, parts, out_dev)])
    rows = share_rows(mesh, rows, out_dev)
    if not rows:
        d0, t0, _ = mesh.local_cells()[0]
        return probe_ops.probe_table(*cells[d0][t0], qhi.to(out_dev),
                                     qlo.to(out_dev), max_probes)
    x = torch.cat([rows[d] for d in sorted(rows)], dim=1)
    return (x[0] != 0,) + tuple(x[k] for k in range(1, 4))
