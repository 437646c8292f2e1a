"""Reference-format CMPH table: probe a .mph + .dat pair directly.

Bug-compatible emulation of the reference's production read path
(cmph_kmer.h:139-147): ``fetch`` = cmph_search + flat array read with NO
membership verification, so k-mers outside the signature set alias onto
arbitrary real records (every slot holds some key's record — the MPH is
a bijection).  A query "misses" only in the rank corner case where
bdz_search returns m (cmph_kmer.h:141: ``kidx >= hash_size_``).

Use this layout to run inference off an existing PATRIC/reference data
dir without conversion, or to reproduce the reference's aliasing
behavior exactly.  For exact-membership semantics, import the store into
a native layout instead (models/pipeline.load_data_dir).

The device probe (ops/probe.probe_cmph, kernel csrc/probe_cmph.cu) runs
the BDZ search per window: the Jenkins hash (3 uint32 lanes) and three
2-bit g lookups select a vertex, and one word read by that vertex
answers.  The rank is a cumsum over assigned vertices, so it never
decreases: the vertices whose rank is below m (a record, not the miss)
are exactly those below one boundary, ``n_live``.  to_device therefore
resolves rank -> record once, when the store opens: a per-vertex word
``vfm`` (the record's fm, 0 past n_live) for the call path and, for the
aux probe, a per-vertex 16-byte record (v0, v1, v2, 0).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..interop import cmph as cmph_io
from .wide_table import _words_on


class CmphKmerTable:
    """Device-probeable view of a reference CMPH store (aliasing
    semantics)."""

    aliasing = True  # probes do NOT verify membership (cmph_kmer.h:138-147)

    def __init__(self, mph: cmph_io.BdzMph, values: np.ndarray):
        self.mph = mph
        if values.shape[0] < mph.m:
            raise ValueError(
                f"value array has {values.shape[0]} records, mph m={mph.m}")
        self.values = values
        self._rank = mph.rank_array()
        # the vertices with a record (rank < m) must be a prefix, which a
        # rank that never decreases gives; the device layout relies on it
        live = self._rank < mph.m
        self.n_live = int(live.sum())
        if not live[:self.n_live].all():
            raise ValueError("BDZ rank decreases: the vertices with rank < m "
                             "are not a prefix")
        # packed value words in the shared (v0, v1, v2) layout
        v = values
        self.v0 = (v["avg_from_end"].astype(np.uint32)
                   | (v["function_index"].astype(np.uint32) << 16))
        self.v1 = (v["mean"].astype(np.uint32)
                   | (v["median"].astype(np.uint32) << 16))
        self.v2 = v["var"].astype(np.uint32)

    # -- shape/introspection -------------------------------------------------

    @property
    def n_items(self) -> int:
        return self.mph.m

    def size(self) -> int:
        return self.mph.m

    def memory_bytes(self) -> int:
        return (self.mph.g.nbytes + self._rank.nbytes + self.v0.nbytes
                + self.v1.nbytes + self.v2.nbytes)

    # -- persistence (reference formats) -------------------------------------

    @staticmethod
    def exists(base) -> bool:
        base = str(base)
        return (Path(base + ".mph").is_file()
                and Path(base + ".dat").is_file())

    @staticmethod
    def load(base) -> "CmphKmerTable":
        base = str(base)
        mph = cmph_io.load_mph(base + ".mph")
        values = cmph_io.read_cmph_values(base + ".dat")
        return CmphKmerTable(mph, values)

    def save(self, base) -> None:
        base = str(base)
        cmph_io.save_mph(base + ".mph", self.mph)
        np.ascontiguousarray(self.values[:self.mph.m]).tofile(base + ".dat")

    # -- host probe ----------------------------------------------------------

    def vertices_np(self, qhi, qlo) -> np.ndarray:
        """Each key's selected BDZ vertex (its rank indexes the values)."""
        keys = cmph_io.keys_from_packed(np.asarray(qhi, np.uint32).reshape(-1),
                                        np.asarray(qlo, np.uint32).reshape(-1))
        h0, h1, h2 = cmph_io.jenkins_hash3_bytes(self.mph.seed, keys)
        r = np.uint32(self.mph.r)
        hl = np.stack([(h0 % r).astype(np.int64),
                       (h1 % r).astype(np.int64) + self.mph.r,
                       (h2 % r).astype(np.int64) + 2 * self.mph.r], axis=1)
        g = self.mph.g
        gv = (g[hl >> 2] >> ((hl & 3) << 1)) & 3
        sel = gv.sum(axis=1) % 3
        return hl[np.arange(hl.shape[0]), sel]

    def _indices_np(self, qhi, qlo) -> np.ndarray:
        return self._rank[self.vertices_np(qhi, qlo)].astype(np.int64)

    def lookup_np(self, qhi, qlo, with_aux: bool = True):
        """Vectorized host probe with ALIASING semantics.

        Returns (found, v0, v1, v2); found is False only for the
        rank == m corner (the reference's only miss path)."""
        shape = np.asarray(qhi).shape
        idx = self._indices_np(qhi, qlo)
        found = idx < self.mph.m
        idxc = np.minimum(idx, self.mph.m - 1)
        z = np.uint32(0)
        r0 = np.where(found, self.v0[idxc], z).reshape(shape)
        r1 = np.where(found, self.v1[idxc], z).reshape(shape)
        r2 = np.where(found, self.v2[idxc], z).reshape(shape)
        return found.reshape(shape), r0, r1, r2

    # -- device -----------------------------------------------------------

    def to_device(self, device, with_aux: bool = False):
        """(g, vfm[, vrec]) on ``device``: g as uint8 bytes; vfm, int32
        (3r,), each vertex's answer for the call path, fm = (v0 &
        0xFFFF0000) | (v1 & 0xFFFF) of record rank[vertex] below n_live
        and 0 from it on (104 MB with g at r = 8.2M, against 264 MB for g,
        rank, v0 and v1); vrec (aux_to_device) only with_aux
        (ops/probe.probe_cmph).  Resolved on the device with gathers."""
        g = torch.from_numpy(np.ascontiguousarray(self.mph.g)).to(device)
        rec = self._records(device, self.v0, self.v1)
        vfm = torch.zeros(self.mph.n, dtype=torch.int32, device=device)
        vfm[:self.n_live] = (rec[:, 0] & -0x10000) | (rec[:, 1] & 0xFFFF)
        return (g, vfm) + (self.aux_to_device(device) if with_aux else ())

    def aux_to_device(self, device):
        """(vrec,) alone, for a caller that already holds the rest: int32
        (3r, 4), each vertex's record (v0, v1, v2, 0) below n_live and
        zeros from it on, 16 bytes (393 MB at r = 8.2M)."""
        vrec = torch.zeros((self.mph.n, 4), dtype=torch.int32, device=device)
        vrec[:self.n_live, :3] = self._records(device, self.v0, self.v1,
                                               self.v2)
        return (vrec,)

    def _records(self, device, *words):
        """(n_live, len(words)) int32 on ``device``: the words of record
        rank[v] for each vertex v below n_live, gathered there."""
        rank, *cols = _words_on(device, self._rank[:self.n_live],
                                *(w[:self.mph.m] for w in words))
        return torch.stack([c.index_select(0, rank) for c in cols], dim=1)

    # -- conversion ----------------------------------------------------------

    def occupied(self):
        """The MPH stores no keys, so the k-mer set cannot be enumerated
        from the store alone (use final.kmers for the keys)."""
        raise NotImplementedError(
            "a CMPH store holds values only; supply keys (e.g. final.kmers) "
            "to enumerate entries")
