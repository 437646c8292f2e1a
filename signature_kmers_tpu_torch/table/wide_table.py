"""Wide-bucket signature table: ONE main row read + one small leaf read.

Layout (same on disk and in memory as the JAX package's wide table, so a
data dir built there loads here):

    main row  = packed[bucket]       2*slots uint32: tag x slots, fm x slots
    overflow  = ov_packed[bucket2]   same layout, slot count = max occupancy

Exactness without storing keys: an invertible 3-round Feistel permutation
of the 48-bit key (ops/hashing.perm48) is split into (bucket, tag); the
split covers all 48 bits, so tag equality inside a bucket IS key equality.
A slot stores (tag, fm) with fm = function<<16 | mean; the full value
words live in the parallel ``aux`` rows (host lookups and later slices).

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
        words) on ``device``: (packed, ov_packed)."""
        if with_aux:
            raise NotImplementedError(
                "the aux tables go to the device with the aux probe "
                "(--debug-hits, matrix distance), a later slice of the port")
        return tuple(torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
                     .to(device) for a in (self.packed, self.ov_packed))

    # -- interop ---------------------------------------------------------------

    def occupied(self):
        """(hi, lo, v0, v1, v2) of stored entries, sorted by key."""
        hi, lo, v0, v1, v2 = _occupied_tagged(self.packed, self.aux,
                                              self.salt, self.bits)
        if self.ov_items:
            oh, ol, o0, o1, o2 = _occupied_tagged(self.ov_packed, self.ov_aux,
                                                  self.ov_salt, self.ov_bits)
            hi = np.concatenate([hi, oh])
            lo = np.concatenate([lo, ol])
            v0 = np.concatenate([v0, o0])
            v1 = np.concatenate([v1, o1])
            v2 = np.concatenate([v2, o2])
        order = np.lexsort((lo, hi))
        return hi[order], lo[order], v0[order], v1[order], v2[order]


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
