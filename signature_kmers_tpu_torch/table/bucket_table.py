"""Bucketed cuckoo signature table (``--table-layout cuckoo``): at most
two row reads per probe, the least memory of the layouts.

Same layout, hashes and files as the JAX package's bucket table, so a
data dir built there loads here and the port's build writes the same
bytes.  Layout: power-of-two bucket count, ``slots`` keys per bucket
(default 2: 24-byte probe rows; 4 gives 48-byte rows), two bucket choices
per key (cuckoo; (2 choices x 2 slots) supports load ~0.89).  A probe
reads at most:

    row1 = packed[h1(key)]   # 3*slots words: khi*s, klo*s, fm*s
    row2 = packed[h2(key)]

where fm = function_index<<16 | mean — the only stored fields the calling
automaton consumes (avg_from_end feeds only the disabled order_constraint
path, ref: call_functions.tcc:307-311).  The full 5-field StoredKmerData
(ref: kmer_data.h:114-128) lives in a parallel aux array gathered only by
the matrix-distance / debug paths (kernel: csrc/probe_bucket.cu).

On the card (to_device) each row is padded to whole 32-byte sectors
(khi*s, klo*s, fm*s, then s zero words) and the aux rows are slot-major,
16 bytes per slot; the host rows and the files stay as they are.

Insertion is vectorized two-choice placement with per-bucket eviction
rounds (random-walk cuckoo); a salted rebuild handles the (rare)
non-convergent layout.  Lookups are exact: keys are stored and compared,
unlike the reference's aliasing CMPH read path (ref: cmph_kmer.h:138-147).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..core.config import TableConfig
from ..ops import hashing
from .wide_table import _words_on, key_order

EMPTY = np.uint32(0xFFFFFFFF)


def bucket_hashes(hi, lo, salt: int, n_buckets: int):
    """Two independent bucket indices for each key (numpy; the torch
    version is ops/hashing.bucket_hashes_t)."""
    hi = np.asarray(hi, dtype=np.uint32)
    lo = np.asarray(lo, dtype=np.uint32)
    s = np.uint32(salt)
    mask = np.uint32(n_buckets - 1)
    h1 = hashing.fmix32(hi ^ hashing.fmix32(lo ^ s))
    h2 = hashing.fmix32(lo ^ hashing.fmix32(hi ^ (s + np.uint32(0x9E3779B9))))
    return h1 & mask, h2 & mask


@dataclasses.dataclass
class BucketKmerTable:
    """Host image of the bucketed table."""

    packed: np.ndarray   # (n_buckets, 3*slots) uint32: khi*s, klo*s, fm*s
    aux: np.ndarray      # (n_buckets, 3*slots) uint32: v0*s, v1*s, v2*s
    salt: int
    n_items: int

    @property
    def n_buckets(self) -> int:
        return int(self.packed.shape[0])

    @property
    def slots(self) -> int:
        return int(self.packed.shape[1]) // 3

    @property
    def size(self) -> int:  # slot capacity
        return self.n_buckets * self.slots

    # -- construction ------------------------------------------------------

    @staticmethod
    def build(hi, lo, v0, v1, v2,
              config: TableConfig = TableConfig(),
              target_load: float = 0.7) -> "BucketKmerTable":
        hi = np.asarray(hi, dtype=np.uint32)
        lo = np.asarray(lo, dtype=np.uint32)
        v0 = np.asarray(v0, dtype=np.uint32)
        v1 = np.asarray(v1, dtype=np.uint32)
        v2 = np.asarray(v2, dtype=np.uint32)
        n = hi.shape[0]
        if n:
            packed_keys = (hi.astype(np.uint64) << 24) | lo
            if np.unique(packed_keys).shape[0] != n:
                raise ValueError(
                    "duplicate k-mer keys in table build input")
        # bucket load target ~0.7 of slot capacity by default; the wide
        # table's overflow store pushes to ~0.85 ((2x2)-cuckoo supports
        # ~0.89) to stay inside the small-gather cached regime
        slots = config.slots
        want_slots = max(config.min_size, int(n / target_load) + slots)
        n_buckets = hashing.next_pow2(-(-want_slots // slots))

        # native single-pass insertion when the toolchain is present
        # (same layout/hashes; ~10x the numpy version's speed)
        from ..runtime import host as _host

        native = _host.available()

        for attempt in range(16):
            salt = 0x5EED0000 + attempt * 0x01000193
            if native:
                res = _host.build_cuckoo(hi, lo, v0, v1, v2, n_buckets, salt,
                                         slots=slots)
                out = None if res is None else tuple(res)
            else:
                out = BucketKmerTable._try_build(hi, lo, v0, v1, v2,
                                                 n_buckets, salt, slots)
            if out is not None:
                return BucketKmerTable._finish(*out, salt, n)
            if attempt >= 3:
                n_buckets *= 2  # give up on density before giving up
        raise RuntimeError("cuckoo build failed to converge")

    @staticmethod
    def _try_build(hi, lo, v0, v1, v2, n_buckets, salt, slots=2):
        n = hi.shape[0]
        SLOTS = slots
        khi = np.full((n_buckets, SLOTS), EMPTY, dtype=np.uint32)
        klo = np.full((n_buckets, SLOTS), EMPTY, dtype=np.uint32)
        fv0 = np.zeros((n_buckets, SLOTS), dtype=np.uint32)
        fv1 = np.zeros((n_buckets, SLOTS), dtype=np.uint32)
        fv2 = np.zeros((n_buckets, SLOTS), dtype=np.uint32)
        fill = np.zeros(n_buckets, dtype=np.int32)
        evict_ptr = np.zeros(n_buckets, dtype=np.int32)

        p_hi, p_lo = hi.copy(), lo.copy()
        p_v0, p_v1, p_v2 = v0.copy(), v1.copy(), v2.copy()
        choice = np.zeros(n, dtype=np.uint8)

        for rnd in range(500):
            if p_hi.size == 0:
                return khi, klo, fv0, fv1, fv2
            h1, h2 = bucket_hashes(p_hi, p_lo, salt, n_buckets)
            t = np.where(choice == 0, h1, h2).astype(np.int64)
            order = np.argsort(t, kind="stable")
            ts = t[order]
            first_pos = np.searchsorted(ts, ts, side="left")
            rank = np.arange(ts.shape[0]) - first_pos
            free = (SLOTS - fill[ts]).astype(np.int64)
            place = rank < free
            # scatter placed entries
            pi = order[place]
            tb = ts[place]
            slot = fill[tb] + rank[place]
            khi[tb, slot] = p_hi[pi]
            klo[tb, slot] = p_lo[pi]
            fv0[tb, slot] = p_v0[pi]
            fv1[tb, slot] = p_v1[pi]
            fv2[tb, slot] = p_v2[pi]
            np.add.at(fill, tb, 1)

            lose = order[~place]
            if lose.size == 0:
                p_hi = p_hi[:0]
                continue
            if rnd < 2:
                # pure two-choice first: losers flip to their other bucket
                choice_l = choice[lose] ^ 1
                p_hi, p_lo = p_hi[lose], p_lo[lose]
                p_v0, p_v1, p_v2 = p_v0[lose], p_v1[lose], p_v2[lose]
                choice = choice_l
                continue
            # eviction: first loser per full bucket kicks out a victim
            lt = ts[~place]
            lrank = rank[~place] - free[~place]
            evictor = lrank == 0
            ei = lose[evictor]
            et = lt[evictor].astype(np.int64)
            vslot = evict_ptr[et] % SLOTS
            evict_ptr[et] += 1
            # read victims
            vk_hi = khi[et, vslot].copy()
            vk_lo = klo[et, vslot].copy()
            vv0 = fv0[et, vslot].copy()
            vv1 = fv1[et, vslot].copy()
            vv2 = fv2[et, vslot].copy()
            # install evictors
            khi[et, vslot] = p_hi[ei]
            klo[et, vslot] = p_lo[ei]
            fv0[et, vslot] = p_v0[ei]
            fv1[et, vslot] = p_v1[ei]
            fv2[et, vslot] = p_v2[ei]
            # victims re-enter with their other bucket as target
            vh1, vh2 = bucket_hashes(vk_hi, vk_lo, salt, n_buckets)
            vchoice = np.where(vh1 == et, 1, 0).astype(np.uint8)
            rest = lose[~evictor]
            p_hi = np.concatenate([p_hi[rest], vk_hi])
            p_lo = np.concatenate([p_lo[rest], vk_lo])
            p_v0 = np.concatenate([p_v0[rest], vv0])
            p_v1 = np.concatenate([p_v1[rest], vv1])
            p_v2 = np.concatenate([p_v2[rest], vv2])
            choice = np.concatenate([choice[rest] ^ 1, vchoice])
        return None

    # (split so _try_build can return the finished table)
    @staticmethod
    def _finish(khi, klo, fv0, fv1, fv2, salt, n_items):
        fm = ((fv0 >> 16) << 16) | (fv1 & 0xFFFF)  # func<<16 | mean
        packed = np.concatenate([khi, klo, fm], axis=1)
        aux = np.concatenate([fv0, fv1, fv2], axis=1)
        return BucketKmerTable(np.ascontiguousarray(packed),
                               np.ascontiguousarray(aux), salt, n_items)

    # -- host probe --------------------------------------------------------

    def lookup_np(self, qhi, qlo, with_aux: bool = True):
        """Vectorized host probe.  Returns (found, v0, v1, v2)."""
        qhi = np.asarray(qhi, dtype=np.uint32)
        qlo = np.asarray(qlo, dtype=np.uint32)
        shape = qhi.shape
        qh = qhi.reshape(-1)
        ql = qlo.reshape(-1)
        b1, b2 = bucket_hashes(qh, ql, self.salt, self.n_buckets)
        SLOTS = self.slots
        found = np.zeros(qh.shape, dtype=bool)
        slot_flat = np.zeros(qh.shape, dtype=np.int64)
        for b in (b1, b2):
            row = self.packed[b]
            m = ((row[:, 0:SLOTS] == qh[:, None])
                 & (row[:, SLOTS:2 * SLOTS] == ql[:, None]))
            f = m.any(axis=1)
            s = m.argmax(axis=1)
            new = f & ~found
            slot_flat = np.where(new, b.astype(np.int64) * SLOTS + s,
                                 slot_flat)
            found |= f
        a = self.aux.reshape(-1, 3, SLOTS)
        bsel = slot_flat // SLOTS
        ssel = slot_flat % SLOTS
        r0 = np.where(found, a[bsel, 0, ssel], 0).astype(np.uint32)
        r1 = np.where(found, a[bsel, 1, ssel], 0).astype(np.uint32)
        r2 = np.where(found, a[bsel, 2, ssel], 0).astype(np.uint32)
        return (found.reshape(shape), r0.reshape(shape),
                r1.reshape(shape), r2.reshape(shape))

    # -- persistence -------------------------------------------------------

    def save(self, path):
        path = Path(path)
        np.savez(path.with_suffix(".npz"), packed=self.packed, aux=self.aux)
        meta = {"n_items": self.n_items, "salt": self.salt,
                "n_buckets": self.n_buckets, "slots": self.slots,
                "format": "skt-bucket-v1"}
        path.with_suffix(".json").write_text(json.dumps(meta))

    @staticmethod
    def load(path) -> "BucketKmerTable":
        path = Path(path)
        z = np.load(path.with_suffix(".npz"))
        meta = json.loads(path.with_suffix(".json").read_text())
        return BucketKmerTable(z["packed"], z["aux"], int(meta["salt"]),
                               int(meta["n_items"]))

    @staticmethod
    def exists(path) -> bool:
        path = Path(path)
        if not (path.with_suffix(".npz").is_file()
                and path.with_suffix(".json").is_file()):
            return False
        meta = json.loads(path.with_suffix(".json").read_text())
        return meta.get("format") == "skt-bucket-v1"

    # -- device ------------------------------------------------------------

    def to_device(self, device, with_aux: bool = False):
        """The probe rows as int32 tensors (bit containers of the uint32
        words) on ``device``, each row padded to whole 32-byte sectors:
        (n_buckets, 4*slots) = [khi x s | klo x s | fm x s | 0 x s], 32
        bytes at 2 slots (512 MiB at 2^24 buckets; the host rows are 24
        bytes), 64 at 4.  -> (rows,), or (rows, aux) with_aux
        (ops/probe.probe_bucket)."""
        rows, = _words_on(device, self.packed)
        return (_pad_last(rows, 4 * self.slots),) + (
            self.aux_to_device(device) if with_aux else ())

    def aux_to_device(self, device):
        """(aux,) alone, for a caller that already holds the probe rows:
        slot-major, 16 bytes per slot, (n_buckets, 4*slots) = [v0, v1,
        v2, 0] x slots, so that a found window's value words are one
        16-byte load inside one sector."""
        s = self.slots
        aux, = _words_on(device, self.aux)
        return (_pad_last(aux.view(-1, 3, s).transpose(1, 2), 4)
                .view(-1, 4 * s),)

    # -- interop -----------------------------------------------------------

    def occupied(self):
        """(hi, lo, v0, v1, v2) of occupied slots, sorted by key."""
        SLOTS = self.slots
        khi = self.packed[:, 0:SLOTS].reshape(-1)
        klo = self.packed[:, SLOTS:2 * SLOTS].reshape(-1)
        a = self.aux.reshape(-1, 3, SLOTS)
        occ = khi != EMPTY
        hi = khi[occ]
        lo = klo[occ]
        v0 = a[:, 0, :].reshape(-1)[occ]
        v1 = a[:, 1, :].reshape(-1)[occ]
        v2 = a[:, 2, :].reshape(-1)[occ]
        order = key_order(hi, lo)
        return hi[order], lo[order], v0[order], v1[order], v2[order]


def _pad_last(t, width: int):
    """t zero-padded to ``width`` in its last dimension, contiguous."""
    out = torch.zeros((*t.shape[:-1], width), dtype=t.dtype, device=t.device)
    out[..., :t.shape[-1]] = t
    return out
