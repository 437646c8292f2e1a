"""StoredKmerData value packing shared by the table layouts, and the
legacy linear-probing store.

The JAX package's first layout was a linear-probing table (five uint32
words per slot: key_hi, key_lo, v0, v1, v2; format "skt-v1").  A data dir
that holds one is converted to the cuckoo layout on load
(models/pipeline.load_data_dir), as the JAX package does, so a data dir's
store is only read and probed on the host here (table-tool's info, dump
and verify).  KmerTable.build places keys in the same layout for the
mesh's linear shards (parallel/sharded_table.py).  On the device a shard
is two row arrays instead of the five words,
ops/probe.linear_rows' keys (S, 2) = (key_hi, key_lo) and vals (S, 4) =
(v0, v1, v2, 0) per slot, which its probe, ops/probe.probe_table, walks.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from ..core.config import TableConfig
from ..ops import hashing
from .wide_table import key_order

EMPTY = np.uint32(0xFFFFFFFF)  # empty-slot key word (keys use 24 bits)


def pack_values(avg_from_end, function_index, mean, median, var):
    """Per-key statistics -> the three uint32 value words
    (v0 = function<<16 | avg_from_end, v1 = median<<16 | mean, v2 = var)."""
    a = np.asarray(avg_from_end, dtype=np.uint32)
    f = np.asarray(function_index, dtype=np.uint32)
    me = np.asarray(mean, dtype=np.uint32)
    md = np.asarray(median, dtype=np.uint32)
    v = np.asarray(var, dtype=np.uint32)
    return (f << 16) | a, (md << 16) | me, v


@dataclasses.dataclass
class KmerTable:
    """Host image of a legacy linear-probing store."""

    key_hi: np.ndarray
    key_lo: np.ndarray
    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    n_items: int
    max_probes: int

    @property
    def size(self) -> int:
        return int(self.key_hi.shape[0])

    @property
    def mask(self) -> int:
        return self.size - 1

    @staticmethod
    def build(hi, lo, v0, v1, v2, config: TableConfig = TableConfig()
              ) -> "KmerTable":
        """Place keys by rounds of slot claiming (the JAX package's
        KmerTable.build, array for array): each round every unplaced key
        tries its current slot, the first contender (in input order) for
        an empty slot takes it, and the others move one slot on.  The
        round count is the longest chain, max_probes."""
        hi = np.asarray(hi, dtype=np.uint32)
        lo = np.asarray(lo, dtype=np.uint32)
        v0 = np.asarray(v0, dtype=np.uint32)
        v1 = np.asarray(v1, dtype=np.uint32)
        v2 = np.asarray(v2, dtype=np.uint32)
        n = hi.shape[0]
        size = max(config.min_size,
                   hashing.next_pow2(int(n / config.load_factor) + 1))
        mask = np.uint32(size - 1)
        key_hi = np.full(size, EMPTY, dtype=np.uint32)
        key_lo = np.full(size, EMPTY, dtype=np.uint32)
        words = [np.zeros(size, dtype=np.uint32) for _ in range(3)]
        pending = np.arange(n)
        cur = hashing.hash_kmer(hi, lo) & mask
        max_probes = 0
        while pending.size:
            max_probes += 1
            if max_probes > max(config.max_probes_cap, size):
                raise RuntimeError("hash table build did not converge")
            slots = cur[pending]
            empty = key_hi[slots] == EMPTY
            # np.unique's first index: the first pending contender
            _, first_idx = np.unique(slots, return_index=True)
            place = np.zeros(pending.size, dtype=bool)
            place[first_idx] = True
            place &= empty
            idx = pending[place]
            s = slots[place]
            key_hi[s] = hi[idx]
            key_lo[s] = lo[idx]
            for w, v in zip(words, (v0, v1, v2)):
                w[s] = v[idx]
            pending = pending[~place]
            cur[pending] = (cur[pending] + np.uint32(1)) & mask
        return KmerTable(key_hi, key_lo, *words, n, max_probes)

    @staticmethod
    def load(path) -> "KmerTable":
        path = Path(path)
        z = np.load(path.with_suffix(".npz"))
        meta = json.loads(path.with_suffix(".json").read_text())
        return KmerTable(z["key_hi"], z["key_lo"], z["v0"], z["v1"], z["v2"],
                         int(meta["n_items"]), int(meta["max_probes"]))

    @staticmethod
    def exists(path) -> bool:
        path = Path(path)
        if not (path.with_suffix(".npz").is_file()
                and path.with_suffix(".json").is_file()):
            return False
        meta = json.loads(path.with_suffix(".json").read_text())
        return meta.get("format") == "skt-v1"

    def occupied(self):
        """(hi, lo, v0, v1, v2) of occupied slots, sorted by key."""
        occ = self.key_hi != EMPTY
        hi = self.key_hi[occ]
        lo = self.key_lo[occ]
        order = key_order(hi, lo)
        return (hi[order], lo[order], self.v0[occ][order],
                self.v1[occ][order], self.v2[occ][order])

    def lookup_np(self, qhi, qlo):
        """Host probe, linear from the key's hashed slot.  Returns
        (found, v0, v1, v2)."""
        qhi = np.asarray(qhi, dtype=np.uint32)
        qlo = np.asarray(qlo, dtype=np.uint32)
        mask = np.uint32(self.mask)
        cur = hashing.hash_kmer(qhi, qlo) & mask
        found = np.zeros(qhi.shape, dtype=bool)
        done = np.zeros(qhi.shape, dtype=bool)
        r0 = np.zeros(qhi.shape, dtype=np.uint32)
        r1 = np.zeros(qhi.shape, dtype=np.uint32)
        r2 = np.zeros(qhi.shape, dtype=np.uint32)
        for _ in range(self.max_probes):
            khi = self.key_hi[cur]
            klo = self.key_lo[cur]
            hit = (khi == qhi) & (klo == qlo) & ~done
            empty = (khi == EMPTY) & ~done
            r0 = np.where(hit, self.v0[cur], r0)
            r1 = np.where(hit, self.v1[cur], r1)
            r2 = np.where(hit, self.v2[cur], r2)
            found |= hit
            done |= hit | empty
            if done.all():
                break
            cur = (cur + np.uint32(1)) & mask
        return found, r0, r1, r2
