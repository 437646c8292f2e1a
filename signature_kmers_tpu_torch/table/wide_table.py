"""Wide-bucket signature table: ONE main row read + one small leaf read.

Layout (same on disk and in memory as the JAX package's wide table, so a
data dir built there loads here):

    main row  = packed[bucket]       2*slots uint32: tag x slots, fm x slots
    overflow  = ov_packed[bucket2]   same layout, slot count = max occupancy

Exactness without storing keys: an invertible 3-round Feistel permutation
of the 48-bit key (ops/hashing.perm48) is split into (bucket, tag); the
split covers all 48 bits, so tag equality inside a bucket IS key equality.
A slot stores (tag, fm) with fm = function<<16 | mean; the full value
words live in the parallel ``aux`` rows (host lookups and the aux probe).

Matrix distance reads one more device layout, built from those two at
first use: a "distance row" per bucket holds everything its filter reads,

    distance row = tag x slots | fm x slots | var16 pairs x ceil(slots/2)

padded with zeros to a multiple of 8 words (32 bytes: one DRAM sector at
2 slots, two at 4), where var16 = v2 & 0xFFFF and a pair word holds slot
2k in its low and slot 2k+1 in its high half.  On the device the main
store's aux rows are padded to a multiple of 4 words (aux_row_words: 32
bytes at 2 slots, so that no row crosses a sector; 48, as on the host, at
4); the leaf's aux rows are not.

Keys that exceed their bucket's slots (the Poisson tail) go to the
overflow leaf: the SAME tagged single-hash layout with bucket count and
slot width chosen from the data so that every overflow key fits.  When a
build has no overflow keys the probe skips the leaf.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..ops import hashing

EMPTY = np.uint32(0xFFFFFFFF)  # empty-slot tag sentinel

# overflow leaf size at which the leaf search stops growing the bucket count
_OV_BUDGET_BYTES = 32 << 20


def key_order(hi, lo) -> np.ndarray:
    """The order that sorts entries by key: np.lexsort((lo, hi)), as one
    stable sort of the 48-bit packed keys on torch's threaded CPU sort."""
    key = (np.asarray(hi, np.int64) << 24) | np.asarray(lo, np.int64)
    return torch.sort(torch.from_numpy(key), stable=True)[1].numpy()


@dataclasses.dataclass(frozen=True)
class WideTableConfig:
    """Parameters of the wide layout (see module docstring)."""

    slots: int = 2          # tagged slots per main bucket (2 -> 16B rows)
    main_load: float = 0.22  # keys per slot target (lambda = slots*load)
    # >= 17 so tags stay <= 31 bits and the 0xFFFFFFFF empty sentinel is
    # unreachable by ANY query's tag (exactness; hashing.wide_bucket_tag)
    min_bits: int = 17
    # Sub-cliff sizing for medium tables: when the key count fits a
    # sub_cliff_bytes main store of 4-slot rows at load <=
    # sub_cliff_max_load, place there and send the Poisson tail to the
    # leaf, accepted only if the leaf stays under the same budget.
    # 0 disables.
    sub_cliff_bytes: int = 64 << 20
    sub_cliff_max_load: float = 0.6


def compact_config() -> WideTableConfig:
    """Half-memory preset (32B rows)."""
    return WideTableConfig(slots=4, main_load=1/3)


_SALT_BASE = 0x51DE_0000
_SALT_STEP = 0x0100_0193
_OV_LAMBDA = 2.5  # overflow keys per overflow bucket target


def _native_host():
    from ..runtime import host

    return host if host.available() else None


def _place_tagged(hi, lo, v0, v1, v2, bits: int, salt: int, S: int):
    """Scatter keys into (tag, fm) slot rows.

    Returns (packed, aux, leftover_idx): leftover = keys whose bucket was
    already full (rank >= S in bucket order, leftover in input order).
    Native C++ single pass when the toolchain is present (byte-identical
    output), else vectorized numpy.
    """
    host = _native_host()
    if host is not None:
        return host.build_wide_place(hi, lo, v0, v1, v2, bits, salt, S)
    return _place_tagged_np(hi, lo, v0, v1, v2, bits, salt, S)


def _place_tagged_np(hi, lo, v0, v1, v2, bits: int, salt: int, S: int):
    nb = 1 << bits
    L, R = hashing.perm48(hi, lo, salt)
    bucket, tag = hashing.wide_bucket_tag(L, R, bits)
    bucket = bucket.astype(np.int64)
    order = np.argsort(bucket, kind="stable")
    bs = bucket[order]
    first = np.searchsorted(bs, bs, side="left")
    rank = np.arange(bs.shape[0]) - first
    main = rank < S
    mi = order[main]
    mb = bs[main]
    ms = rank[main]

    ktag = np.full((nb, S), EMPTY, dtype=np.uint32)
    kfm = np.zeros((nb, S), dtype=np.uint32)
    a0 = np.zeros((nb, S), dtype=np.uint32)
    a1 = np.zeros((nb, S), dtype=np.uint32)
    a2 = np.zeros((nb, S), dtype=np.uint32)
    ktag[mb, ms] = tag[mi]
    kfm[mb, ms] = ((v0[mi] >> 16) << 16) | (v1[mi] & 0xFFFF)
    a0[mb, ms] = v0[mi]
    a1[mb, ms] = v1[mi]
    a2[mb, ms] = v2[mi]
    packed = np.ascontiguousarray(np.concatenate([ktag, kfm], axis=1))
    aux = np.ascontiguousarray(np.concatenate([a0, a1, a2], axis=1))
    return packed, aux, np.sort(order[~main])


def _lookup_tagged(packed, aux, salt: int, bits: int, qh, ql):
    """Host mirror of the device tagged-bucket probe (1-D inputs)."""
    S = packed.shape[1] // 2
    L, R = hashing.perm48(qh, ql, salt)
    bucket, tag = hashing.wide_bucket_tag(L, R, bits)
    bucket = bucket.astype(np.int64)
    row = packed[bucket]
    m = row[:, 0:S] == tag[:, None]
    f = m.any(axis=1)
    s = m.argmax(axis=1)
    a = aux.reshape(-1, 3, S)
    r0 = np.where(f, a[bucket, 0, s], 0).astype(np.uint32)
    r1 = np.where(f, a[bucket, 1, s], 0).astype(np.uint32)
    r2 = np.where(f, a[bucket, 2, s], 0).astype(np.uint32)
    return f, r0, r1, r2


def _occupied_tagged(packed, aux, salt: int, bits: int):
    """Reconstruct (hi, lo, v0, v1, v2) from a tagged store: the layout
    stores no keys, yet loses none (Feistel inverse)."""
    S = packed.shape[1] // 2
    ktag = packed[:, 0:S]
    occ = ktag != EMPTY
    b_idx, s_idx = np.nonzero(occ)
    tag = ktag[b_idx, s_idx]
    bucket = b_idx.astype(np.uint32)
    if bits <= 24:
        L = tag >> np.uint32(24 - bits)
        R = (((tag & np.uint32((1 << (24 - bits)) - 1)) << np.uint32(bits))
             | bucket).astype(np.uint32)
    else:
        L = ((tag << np.uint32(bits - 24))
             | (bucket >> np.uint32(24))).astype(np.uint32)
        R = bucket & np.uint32(0xFFFFFF)
    hi, lo = hashing.perm48_inv(L, R, salt)
    a = aux.reshape(packed.shape[0], 3, S)
    return (hi, lo, a[b_idx, 0, s_idx], a[b_idx, 1, s_idx],
            a[b_idx, 2, s_idx])


def aux_row_words(slots: int) -> int:
    """Words per main aux row on the device (module docstring): 8 at 2
    slots, 12 at 4."""
    return -(-3 * slots // 4) * 4


def distance_row_words(slots: int) -> int:
    """Words per distance row (module docstring): 8 at 2 slots, 16 at 4."""
    return -(-(2 * slots + -(-slots // 2)) // 8) * 8


def distance_rows(packed: np.ndarray, aux: np.ndarray) -> np.ndarray:
    """(n, distance_row_words(S)) uint32 distance rows of a tagged store's
    probe rows (n, 2S) and aux rows (n, 3S)."""
    S = packed.shape[1] // 2
    out = np.zeros((packed.shape[0], distance_row_words(S)), np.uint32)
    out[:, :2 * S] = packed
    var = aux[:, 2 * S:3 * S] & np.uint32(0xFFFF)
    for k in range(0, S, 2):
        word = var[:, k].copy()
        if k + 1 < S:
            word |= var[:, k + 1] << np.uint32(16)
        out[:, 2 * S + k // 2] = word
    return out


def leaf_salt(hi, lo, bits: int):
    """Best overflow salt at a fixed bucket count: (salt, max_occupancy)."""
    best = None
    for attempt in range(6):
        salt = (_SALT_BASE ^ 0x00F1_F0F0) + attempt * _SALT_STEP
        L, R = hashing.perm48(hi, lo, salt)
        bucket, _tag = hashing.wide_bucket_tag(L, R, bits)
        mx = int(np.bincount(bucket.astype(np.int64),
                             minlength=1 << bits).max())
        if best is None or mx < best[1]:
            best = (salt, mx)
    return best


def _build_leaf(hi, lo, v0, v1, v2):
    """Overflow store: tagged single-hash rows wide enough that EVERY key
    fits its bucket (slot count = observed max occupancy; data-driven, no
    second-level overflow).  Returns (packed, aux, salt, bits)."""
    n = hi.shape[0]
    if n == 0:
        # bits value is never consulted: the probe skips the leaf when
        # ov_items == 0
        return (np.full((1, 2), EMPTY, dtype=np.uint32),
                np.zeros((1, 3), dtype=np.uint32), _SALT_BASE, 17)
    bits0 = max(17, int(np.ceil(np.log2(max(n / _OV_LAMBDA, 1)))))
    # pick (bits, salt) minimizing total bytes = n_buckets * 8 * max_occ;
    # more buckets trims the occupancy tail but rarely pays for itself
    best = None  # (bytes, salt, bits, S)
    for bits in range(bits0, min(bits0 + 3, 31)):
        salt, mx = leaf_salt(hi, lo, bits)
        size = (1 << bits) * 8 * mx
        if best is None or size < best[0]:
            best = (size, salt, bits, mx)
        if best[0] <= _OV_BUDGET_BYTES:
            break
    _, salt, bits, S = best
    packed, aux, leftover = _place_tagged(hi, lo, v0, v1, v2, bits, salt, S)
    if leftover.shape[0]:
        raise RuntimeError("overflow leaf placement left keys unplaced")
    return packed, aux, salt, bits


@dataclasses.dataclass
class WideKmerTable:
    """Host image of the wide table (+ same-layout overflow store)."""

    packed: np.ndarray      # (n_buckets, 2*slots) uint32: tag*s, fm*s
    aux: np.ndarray         # (n_buckets, 3*slots) uint32: v0*s, v1*s, v2*s
    ov_packed: np.ndarray   # overflow store, same layout
    ov_aux: np.ndarray
    salt: int
    bits: int
    ov_salt: int
    ov_bits: int
    n_items: int
    ov_items: int

    @property
    def n_buckets(self) -> int:
        return int(self.packed.shape[0])

    @property
    def slots(self) -> int:
        return int(self.packed.shape[1]) // 2

    @property
    def ov_slots(self) -> int:
        return int(self.ov_packed.shape[1]) // 2

    @property
    def size(self) -> int:  # slot capacity, the overflow store's included
        return (self.n_buckets * self.slots
                + self.ov_packed.shape[0] * self.ov_slots)

    # -- construction --------------------------------------------------------

    @staticmethod
    def build(hi, lo, v0, v1, v2,
              config: WideTableConfig = WideTableConfig(),
              bits: "int | None" = None) -> "WideKmerTable":
        hi, lo, v0, v1, v2 = (np.asarray(a, dtype=np.uint32)
                              for a in (hi, lo, v0, v1, v2))
        if config.min_bits < 17:
            raise ValueError("wide table min_bits must be >= 17 "
                             "(tag/sentinel exactness)")
        n = hi.shape[0]
        if n and _native_host() is None:
            # the native placement detects duplicates itself (same bucket
            # + same tag == same key); the numpy fallback needs the check
            packed_keys = (hi.astype(np.uint64) << 24) | lo
            if np.unique(packed_keys).shape[0] != n:
                raise ValueError("duplicate k-mer keys in table build input")

        S = config.slots

        def _assemble(bits_, S_):
            salt = _SALT_BASE
            packed, aux, ov_idx = _place_tagged(hi, lo, v0, v1, v2,
                                                bits_, salt, S_)
            ov_packed, ov_aux, ov_salt, ov_bits = _build_leaf(
                hi[ov_idx], lo[ov_idx], v0[ov_idx], v1[ov_idx], v2[ov_idx])
            return WideKmerTable(packed, aux, ov_packed, ov_aux, salt,
                                 bits_, ov_salt, ov_bits, n,
                                 int(ov_idx.shape[0]))

        if bits is not None:
            return _assemble(max(config.min_bits, min(int(bits), 30)), S)

        want_buckets = int(n / (S * config.main_load)) + 1
        bits = max(config.min_bits,
                   hashing.next_pow2(want_buckets).bit_length() - 1)
        bits = min(bits, 30)

        # sub-cliff sizing (see WideTableConfig): 4-slot 32 B rows at a
        # fixed byte budget keep the slot capacity but double bucket
        # occupancy, which collapses the Poisson overflow tail
        sub = config.sub_cliff_bytes
        if sub:
            S_sub = max(S, 4)
            row_bytes = 8 * S_sub
            bits_cap = max(config.min_bits,
                           (sub // row_bytes).bit_length() - 1)
            fits = n <= (1 << bits_cap) * S_sub * config.sub_cliff_max_load
            if (1 << bits) * 8 * S > sub and fits:
                t = _assemble(bits_cap, S_sub)
                if t.ov_packed.nbytes <= sub:
                    return t
                # overflow outgrew the budget: fall through to default
        return _assemble(bits, S)

    @staticmethod
    def from_stats(hi, lo, avg_from_end, function_index, mean, median, var,
                   config: WideTableConfig = WideTableConfig()) -> "WideKmerTable":
        from .kmer_table import pack_values

        v0, v1, v2 = pack_values(avg_from_end, function_index, mean,
                                 median, var)
        return WideKmerTable.build(hi, lo, v0, v1, v2, config)

    # -- host probe ----------------------------------------------------------

    def lookup_np(self, qhi, qlo):
        """Vectorized host probe.  Returns (found, v0, v1, v2)."""
        qhi = np.asarray(qhi, dtype=np.uint32)
        qlo = np.asarray(qlo, dtype=np.uint32)
        shape = qhi.shape
        qh = qhi.reshape(-1)
        ql = qlo.reshape(-1)
        f1, r0, r1, r2 = _lookup_tagged(self.packed, self.aux, self.salt,
                                        self.bits, qh, ql)
        if self.ov_items:
            f2, o0, o1, o2 = _lookup_tagged(self.ov_packed, self.ov_aux,
                                            self.ov_salt, self.ov_bits,
                                            qh, ql)
            r0 = np.where(f1, r0, o0)
            r1 = np.where(f1, r1, o1)
            r2 = np.where(f1, r2, o2)
            f1 = f1 | f2
        return (f1.reshape(shape), r0.reshape(shape).astype(np.uint32),
                r1.reshape(shape).astype(np.uint32),
                r2.reshape(shape).astype(np.uint32))

    # -- persistence ----------------------------------------------------------

    def save(self, path, compact: bool = True, entries=None):
        """Persist the table as ``<path>.{npz,json}``.

        compact=True (default) stores the sorted (key, value) entry arrays
        (20 bytes per key, ``skt-wide-compact-v1``) and re-places them on
        load; compact=False writes the placed arrays as they are
        (``skt-wide-v2``).  Both load in either package.

        entries: (hi, lo, v0, v1, v2) of this table's entries when the
        caller still holds them (the build does), which skips occupied()'s
        key inversion and sort; placement does not depend on their order.
        """
        path = Path(path)
        if compact:
            if entries is not None:
                hi, lo, v0, v1, v2 = entries
                if hi.shape[0] != self.n_items:
                    raise ValueError(f"entries: {hi.shape[0]} keys for a "
                                     f"table of {self.n_items}")
            else:
                hi, lo, v0, v1, v2 = self.occupied()
            np.savez(path.with_suffix(".npz"),
                     hi=hi, lo=lo, v0=v0, v1=v1, v2=v2)
            # enough geometry to rebuild the same layout whatever config
            # produced it: slots + explicit bucket bits
            meta = {"n_items": self.n_items, "slots": self.slots,
                    "bits": self.bits,
                    "format": "skt-wide-compact-v1"}
            path.with_suffix(".json").write_text(json.dumps(meta))
            return
        np.savez(path.with_suffix(".npz"), packed=self.packed, aux=self.aux,
                 ov_packed=self.ov_packed, ov_aux=self.ov_aux)
        meta = {"n_items": self.n_items, "ov_items": self.ov_items,
                "salt": self.salt, "bits": self.bits,
                "ov_salt": self.ov_salt, "ov_bits": self.ov_bits,
                "slots": self.slots, "format": "skt-wide-v2"}
        path.with_suffix(".json").write_text(json.dumps(meta))

    @staticmethod
    def load(path) -> "WideKmerTable":
        """Load ``<path>.{npz,json}`` in either wide format: the compact
        entry list (``skt-wide-compact-v1``, re-placed here) or the placed
        arrays (``skt-wide-v2``)."""
        path = Path(path)
        z = np.load(path.with_suffix(".npz"))
        meta = json.loads(path.with_suffix(".json").read_text())
        if meta.get("format") == "skt-wide-compact-v1":
            cfg = WideTableConfig(slots=int(meta.get("slots", 2)))
            return WideKmerTable.build(z["hi"], z["lo"], z["v0"], z["v1"],
                                       z["v2"], cfg,
                                       bits=meta.get("bits"))
        return WideKmerTable(z["packed"], z["aux"], z["ov_packed"],
                             z["ov_aux"], int(meta["salt"]),
                             int(meta["bits"]), int(meta["ov_salt"]),
                             int(meta["ov_bits"]), int(meta["n_items"]),
                             int(meta["ov_items"]))

    @staticmethod
    def exists(path) -> bool:
        path = Path(path)
        if not (path.with_suffix(".npz").is_file()
                and path.with_suffix(".json").is_file()):
            return False
        meta = json.loads(path.with_suffix(".json").read_text())
        return meta.get("format") in ("skt-wide-v2", "skt-wide-compact-v1")

    # -- device ---------------------------------------------------------------

    def to_device(self, device, with_aux: bool = False):
        """Table words as int32 tensors (bit containers of the uint32
        words) on ``device``: (packed, ov_packed), or (packed, ov_packed,
        aux, ov_aux) with_aux.  The aux rows (aux_to_device) are 1.5-2x
        the probe rows, so they go up only when asked."""
        tables = _words_on(device, self.packed, self.ov_packed)
        return tables + self.aux_to_device(device) if with_aux else tables

    def aux_to_device(self, device):
        """(aux, ov_aux) alone, for a caller that already holds the probe
        rows on ``device``: the main store's rows padded to
        aux_row_words(slots) words (2 GiB at bits 26 and 2 slots, 1.5 GiB
        unpadded), the leaf's as they are."""
        return (_rows_on(device, self.aux, aux_row_words(self.slots),
                         lambda a: a),
                *_words_on(device, self.ov_aux))

    def distance_rows_to_device(self, device):
        """(drows, ov_drows): the main store's and the leaf's distance rows
        as int32 tensors on ``device`` (module docstring; 2 GiB at bits 26
        and 2 slots), built on the host a slice of buckets at a time."""
        return (_distance_rows_on(device, self.packed, self.aux),
                _distance_rows_on(device, self.ov_packed, self.ov_aux))

    # -- interop ---------------------------------------------------------------

    def occupied(self):
        """(hi, lo, v0, v1, v2) of stored entries, sorted by key."""
        stores = [(self.packed, self.aux, self.salt, self.bits)]
        if self.ov_items:
            stores.append((self.ov_packed, self.ov_aux, self.ov_salt,
                           self.ov_bits))
        host = _native_host()
        if host is None:
            hi, lo, v0, v1, v2 = (np.concatenate(c) for c in zip(
                *(_occupied_tagged(*store) for store in stores)))
            order = key_order(hi, lo)
            return hi[order], lo[order], v0[order], v1[order], v2[order]
        # one native pass over the slots, split over the host's threads;
        # the keys are distinct (each is stored once), so torch's threaded
        # unstable sort orders them as the stable one does, and hi, lo come
        # from the sorted keys themselves
        key, vals = host.occupied_tagged(stores, self.n_items)
        key, order = torch.sort(torch.from_numpy(key))
        vals = torch.from_numpy(vals.view(np.int32)).index_select(0, order)
        words = (key >> 24, key & 0xFFFFFF)
        hi, lo = (w.to(torch.int32).numpy().view(np.uint32) for w in words)
        v0, v1, v2 = vals.t().contiguous().numpy().view(np.uint32)
        return hi, lo, v0, v1, v2


def _rows_on(device, rows, words: int, make, *more, chunk: int = 1 << 21):
    """(n, words) int32 rows on ``device``: make(rows[a:b], *more[a:b])
    zero-padded to ``words``, a slice of buckets at a time."""
    n = rows.shape[0]
    out = torch.zeros((n, words), dtype=torch.int32, device=device)
    for a in range(0, n, chunk):
        part = make(rows[a:a + chunk], *(m[a:a + chunk] for m in more))
        out[a:a + chunk, :part.shape[1]].copy_(
            torch.from_numpy(np.ascontiguousarray(part).view(np.int32)))
    return out


def _distance_rows_on(device, packed, aux):
    return _rows_on(device, packed, distance_row_words(packed.shape[1] // 2),
                    distance_rows, aux)


def _words_on(device, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
                 .to(device) for a in arrays)


def table_from_jax_arrays(packed, aux, ov_packed, ov_aux, salt, bits,
                          ov_salt, ov_bits, n_items, ov_items
                          ) -> WideKmerTable:
    """The JAX package's WideKmerTable host image (numpy arrays plus
    geometry) -> this package's table; the arrays are shared, not copied."""
    return WideKmerTable(
        *(np.asarray(a, dtype=np.uint32)
          for a in (packed, aux, ov_packed, ov_aux)),
        int(salt), int(bits), int(ov_salt), int(ov_bits), int(n_items),
        int(ov_items))
