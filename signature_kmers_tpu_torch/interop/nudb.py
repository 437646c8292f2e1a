"""NuDB store files: pure-numpy reader.

The reference persists its signature set as a NuDB key/value store of
8-byte k-mer keys -> 10-byte StoredKmerData values, created with
``nudb::create<nudb::xxhasher>(..., appnum=1, key_size=8, block_size,
load_factor=0.5)`` (ref: nudb_kmer_db.h:55-63).  NuDB's on-disk format
(nudb/detail/format.hpp, version 2; all integers BIG-endian, uint48 =
6 bytes):

  <base>.dat  ::=  DatHeader  Record*
    DatHeader  ::=  "nudb.dat"  u16 version  u64 uid  u64 appnum
                    u16 key_size  u8 reserved[64]            (92 bytes)
    Record     ::=  DataRecord | SpillRecord
    DataRecord ::=  u48 size(>0)  u8 key[key_size]  u8 value[size]
    SpillRecord::=  u48 0  u16 size  BucketImage(size bytes)

  <base>.key  ::=  KeyHeader (padded to one block)  Bucket*
    KeyHeader  ::=  "nudb.key"  u16 version  u64 uid  u64 appnum
                    u16 key_size  u64 salt  u64 pepper  u16 block_size
                    u16 load_factor(x 2^16)  u8 reserved[56]  (104 bytes)

    Bucket     ::=  u16 count  u48 spill  Entry[count]  (one per block)
    Entry      ::=  u48 offset  u48 size  u48 hash      (sorted by hash)

  hash = XXH64(key, key_size, seed=salt) truncated to 48 bits;
  bucket index = h % modulus, minus modulus/2 if >= buckets, with
  modulus = ceil_pow2(buckets).

Reading needs only the .dat file: it is an append-only log holding every
(key, value) pair, so this reader scans it and ignores the key file (a
damaged or missing .key file still loads).  read_nudb_header parses the
key file's header for tools that want its salt and geometry.  write_nudb
writes a valid pair (bucket-placed, hash-sorted, spill-chained) that
nudb::store::open/fetch accepts, with numpy byte images in place of a
loop per key; fetch_nudb reads through the key file's buckets as NuDB's
own fetch does.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from .hashes import xxh64_bytes8, xxh64_u64

DAT_TYPE = b"nudb.dat"
KEY_TYPE = b"nudb.key"
VERSION = 2
MASK48 = (1 << 48) - 1

_DAT_HEADER = struct.Struct(">8sHQQH64s")   # 92 bytes
_KEY_HEADER = struct.Struct(">8sHQQHQQHH56s")  # 104 bytes
_BUCKET_HEADER_SIZE = 2 + 6
_ENTRY_SIZE = 6 + 6 + 6
# a numpy view of the log covers _RUN_MIN data records, doubling while each
# view is one run, up to _RUN_MAX
_RUN_MIN = 16
_RUN_MAX = 1 << 20


def _u48(v: int) -> bytes:
    return int(v).to_bytes(6, "big")


def _ceil_pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def bucket_capacity(block_size: int) -> int:
    return (block_size - _BUCKET_HEADER_SIZE) // _ENTRY_SIZE


def bucket_index(h: np.ndarray, buckets: int, modulus: int) -> np.ndarray:
    n = h % np.uint64(modulus)
    return np.where(n >= buckets, n - np.uint64(modulus // 2),
                    n).astype(np.int64)


def pepper(salt: int) -> int:
    """NuDB's stored hash-function fingerprint: the hash of the salt with
    itself as seed (format.hpp pepper<Hasher>); the reader never checks
    it, only NuDB itself would."""
    data = np.frombuffer(struct.pack("<Q", salt), dtype="<u8")
    return int(xxh64_u64(data, salt)[0])


def _be48(v: np.ndarray) -> np.ndarray:
    """uint64 values -> (N, 6) uint8, the low 48 bits big-endian."""
    return np.ascontiguousarray(
        v.astype(">u8").view(np.uint8).reshape(-1, 8)[:, 2:])


def _be_sizes(rows: np.ndarray) -> np.ndarray:
    """The 48-bit big-endian size field at the start of each row."""
    b = rows[:, :6].astype(np.uint64)
    return ((b[:, 0] << np.uint64(40)) | (b[:, 1] << np.uint64(32))
            | (b[:, 2] << np.uint64(24)) | (b[:, 3] << np.uint64(16))
            | (b[:, 4] << np.uint64(8)) | b[:, 5])


def read_nudb_dat(dat_path):
    """Scan a NuDB .dat file -> (keys (N, key_size) uint8, values
    (N, value_size) uint8 when every value has one size, else a list of
    bytes), in log order; spill records are skipped.

    The log is read as runs of equal-size data records, each a strided
    numpy view that ends before the first record of another size or the
    first spill record, where the next view starts.  A view starts at
    _RUN_MIN records and doubles while it holds one run (to _RUN_MAX), and
    starts small again after a run ends, so the scan stays linear in the
    log however often the sizes change.  The reference's stores (10-byte
    StoredKmerData values, spill records only where a bucket overflowed)
    read in a few views per million keys.
    """
    raw = np.fromfile(dat_path, dtype=np.uint8)
    if raw.shape[0] < _DAT_HEADER.size:
        raise ValueError(f"{dat_path}: truncated dat header")
    typ, version, uid, appnum, key_size, _ = _DAT_HEADER.unpack_from(
        raw[:_DAT_HEADER.size].tobytes())
    if typ != DAT_TYPE:
        raise ValueError(f"{dat_path}: not a nudb dat file ({typ!r})")
    body = raw[_DAT_HEADER.size:]
    n_body = body.shape[0]
    if n_body == 0:
        return np.zeros((0, key_size), np.uint8), np.zeros((0, 0), np.uint8)

    keys, values = [], []
    off = 0
    run = _RUN_MIN
    while off + 6 <= n_body:
        size = int.from_bytes(body[off:off + 6].tobytes(), "big")
        if size == 0:  # a spill record: u48 0, u16 size, bucket image
            if off + 8 > n_body:
                break
            off += 8 + int.from_bytes(body[off + 6:off + 8].tobytes(), "big")
            run = _RUN_MIN
            continue
        stride = 6 + key_size + size
        n = min((n_body - off) // stride, run)
        if n == 0:  # a last record cut short: its bytes as they are
            keys.append(body[off + 6:off + 6 + key_size])
            values.append(body[off + 6 + key_size:off + 6 + key_size + size])
            break
        rec = body[off:off + n * stride].reshape(n, stride)
        other = np.flatnonzero(_be_sizes(rec) != size)
        if other.shape[0]:
            n = int(other[0])
            run = _RUN_MIN
        else:
            run = min(2 * run, _RUN_MAX)
        keys.append(rec[:n, 6:6 + key_size])
        values.append(rec[:n, 6 + key_size:])
        off += n * stride
    karr = (np.concatenate([k.reshape(-1) for k in keys]) if keys
            else np.zeros(0, np.uint8)).reshape(-1, key_size)
    if values and all(v.ndim == 2 for v in values) and len(
            {v.shape[1] for v in values}) == 1:
        return karr, np.concatenate(values)
    return karr, [row.tobytes() for v in values
                  for row in (v if v.ndim == 2 else [v])]


def read_nudb_header(key_path):
    """Parse a .key header -> dict (salt, block_size, key_size, ...)."""
    with open(key_path, "rb") as f:
        hdr = f.read(_KEY_HEADER.size)
    (typ, version, uid, appnum, key_size, salt, pep, block_size,
     load_factor, _) = _KEY_HEADER.unpack(hdr)
    if typ != KEY_TYPE:
        raise ValueError(f"{key_path}: not a nudb key file ({typ!r})")
    return dict(version=version, uid=uid, appnum=appnum, key_size=key_size,
                salt=salt, pepper=pep, block_size=block_size,
                load_factor=load_factor / 65536.0)


def is_nudb_dat(base) -> bool:
    """Whether <base>.dat is a NuDB data file (its magic)."""
    from pathlib import Path

    p = Path(str(base) + ".dat")
    if not p.is_file():
        return False
    with open(p, "rb") as f:
        return f.read(8) == DAT_TYPE


def _bucket_hash_order(h, bidx, modulus: int) -> np.ndarray:
    """np.lexsort((h, bidx)) as one stable sort of a 49-bit key.  Within a
    bucket, h's low log2(modulus) bits take at most two values (the bucket,
    or the bucket plus modulus / 2), so the bits above them and the top one
    of them order h there."""
    mbits = modulus.bit_length() - 1
    key = (h >> np.uint64(mbits)) << np.uint64(1)
    if mbits:
        key |= (h >> np.uint64(mbits - 1)) & np.uint64(1)
    key |= bidx.astype(np.uint64) << np.uint64(49 - mbits)
    _, order = torch.sort(torch.from_numpy(key.view(np.int64)), stable=True)
    return order.numpy()


def write_nudb(base, keys: np.ndarray, values: np.ndarray, appnum: int = 1,
               block_size: int = 4096, load_factor: float = 0.5,
               salt: int | None = None, uid: int | None = None) -> None:
    """Write <base>.dat + <base>.key for (N, 8) uint8 keys and
    (N, value_size) uint8 values (duplicate keys not checked).

    Buckets are sized for the load factor (the reference creates its store
    with 0.5, nudb_kmer_db.h:61).  The data file holds one record per key
    in the given order, then the spill records; the key file is one image
    of (buckets + 1) blocks.  A bucket's entries are sorted by hash (ties
    in key order); the key file keeps its first ``bucket_capacity``
    entries, and the rest chain through spill records, appended last chunk
    first as NuDB's own inserts spill.  salt, then uid, default to
    os.urandom(8) each.
    """
    keys = np.ascontiguousarray(keys, dtype=np.uint8)
    values = np.ascontiguousarray(values, dtype=np.uint8)
    n, key_size = keys.shape
    if key_size != 8:
        raise NotImplementedError("NuDB stores of 8-byte keys only (the "
                                  "reference's key size)")
    value_size = values.shape[1] if values.ndim == 2 else 0
    if salt is None:
        salt = int.from_bytes(os.urandom(8), "little")
    if uid is None:
        uid = int.from_bytes(os.urandom(8), "little")

    base = str(base)
    cap = bucket_capacity(block_size)
    buckets = max(1, -(-n // max(1, int(load_factor * cap))))
    modulus = _ceil_pow2(buckets)
    rec_size = 6 + key_size + value_size
    dat_end = _DAT_HEADER.size + n * rec_size

    # key file image: header block, then one block per bucket
    image = np.zeros((buckets + 1, block_size), dtype=np.uint8)
    pep = pepper(salt)
    lf16 = min(65535, int(round(load_factor * 65536)))
    hdr = _KEY_HEADER.pack(KEY_TYPE, VERSION, uid, appnum, key_size, salt,
                           pep, block_size, lf16, b"\x00" * 56)
    image[0, :len(hdr)] = np.frombuffer(hdr, np.uint8)

    spills = bytearray()
    if n:
        h = xxh64_bytes8(keys, salt) & np.uint64(MASK48)
        bidx = bucket_index(h, buckets, modulus)
        order = _bucket_hash_order(h, bidx, modulus)
        sb = bidx[order]
        starts = np.flatnonzero(np.r_[True, sb[1:] != sb[:-1]])
        counts = np.diff(np.r_[starts, n])
        heads = sb[starts]
        rank = np.arange(n, dtype=np.int64) - np.repeat(starts, counts)
        entry = np.empty((n, _ENTRY_SIZE), np.uint8)  # in sorted order
        entry[:, 0:6] = _be48(_DAT_HEADER.size
                              + order.astype(np.uint64) * np.uint64(rec_size))
        entry[:, 6:12] = _be48(np.full(1, value_size, np.uint64))
        entry[:, 12:18] = _be48(h[order])
        del h, bidx

        # the key file's bucket: up to cap entries, then its spill pointer
        head_spill = np.zeros(heads.shape[0], np.uint64)
        for g in np.flatnonzero(counts > cap):
            s, c = int(starts[g]), int(counts[g])
            spill = 0
            for j in reversed(range(cap, c, cap)):
                rows = entry[s + j:s + min(j + cap, c)]
                img = (struct.pack(">H", rows.shape[0]) + _u48(spill)
                       + rows.tobytes())
                spill = dat_end + len(spills)
                spills += _u48(0) + struct.pack(">H", len(img)) + img
            head_spill[g] = spill
        rows = image[1:]
        rows[heads, 0:2] = np.minimum(counts, cap).astype(">u2").view(
            np.uint8).reshape(-1, 2)
        rows[heads, 2:8] = _be48(head_spill)
        slots = image[1:, _BUCKET_HEADER_SIZE:
                      _BUCKET_HEADER_SIZE + cap * _ENTRY_SIZE].reshape(
            buckets, cap, _ENTRY_SIZE)
        first = np.flatnonzero(rank < cap)
        slots[sb[first], rank[first]] = entry[first]

    with open(base + ".dat", "wb") as f:
        f.write(_DAT_HEADER.pack(DAT_TYPE, VERSION, uid, appnum, key_size,
                                 b"\x00" * 64))
        if n:
            recs = np.empty((n, rec_size), dtype=np.uint8)
            recs[:, 0:6] = _be48(np.full(1, value_size, np.uint64))
            recs[:, 6:6 + key_size] = keys
            recs[:, 6 + key_size:] = values
            f.write(recs.data)
            del recs
        f.write(spills)
    with open(base + ".key", "wb") as f:
        f.write(image.data)


def fetch_nudb(base, query_keys: np.ndarray):
    """Fetch through the key file's buckets and spill chains, as NuDB's own
    fetch does (what proves the writer's bucket placement valid).

    Returns (found bool (N,), values (N, value_size) uint8).
    """
    base = str(base)
    hdr = read_nudb_header(base + ".key")
    key_size = hdr["key_size"]
    block_size = hdr["block_size"]
    salt = hdr["salt"]
    kf = np.fromfile(base + ".key", dtype=np.uint8)
    dat = np.fromfile(base + ".dat", dtype=np.uint8)
    buckets = kf.shape[0] // block_size - 1
    modulus = _ceil_pow2(buckets)

    q = np.ascontiguousarray(query_keys, dtype=np.uint8)
    nq = q.shape[0]
    h = xxh64_bytes8(q, salt) & np.uint64(MASK48)
    bidx = bucket_index(h, buckets, modulus)

    def parse_bucket(img: bytes):
        count, = struct.unpack_from(">H", img, 0)
        spill = int.from_bytes(img[2:8], "big")
        entries = []
        for i in range(count):
            o = _BUCKET_HEADER_SIZE + i * _ENTRY_SIZE
            entries.append((int.from_bytes(img[o:o + 6], "big"),
                            int.from_bytes(img[o + 6:o + 12], "big"),
                            int.from_bytes(img[o + 12:o + 18], "big")))
        return entries, spill

    found = np.zeros(nq, dtype=bool)
    out = None
    for i in range(nq):
        blk = (1 + int(bidx[i])) * block_size
        img = kf[blk:blk + block_size].tobytes()
        hv = int(h[i])
        while True:
            entries, spill = parse_bucket(img)
            for off, size, eh in entries:
                if eh != hv:
                    continue
                rk = dat[off + 6:off + 6 + key_size]
                if (rk == q[i]).all():
                    val = dat[off + 6 + key_size:off + 6 + key_size + size]
                    if out is None:
                        out = np.zeros((nq, size), np.uint8)
                    out[i] = val
                    found[i] = True
                    break
            if found[i] or spill == 0:
                break
            ssize, = struct.unpack_from(">H", dat[spill + 6:spill + 8]
                                        .tobytes())
            img = dat[spill + 8:spill + 8 + ssize].tobytes()
    if out is None:
        out = np.zeros((nq, 0), np.uint8)
    return found, out
