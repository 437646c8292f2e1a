"""Wide-table probe: one main row read + one small overflow-leaf read per
window (kernel: csrc/probe_wide.cu).

The table (table/wide_table.py) stores per bucket ``slots`` (tag, fm)
pairs; fm = function<<16 | mean.  A window's 48-bit key is permuted
(ops/hashing.perm48), split into (bucket, tag), and matched against the
bucket's tags; the overflow leaf is searched the same way with its own
salt and bits when the build had overflow keys.
"""

from __future__ import annotations

import torch

from . import cuda_launch as cl
from . import hashing

_M32 = 0xFFFF_FFFF


def _tagged_match(packed: torch.Tensor, hi, lo, salt: int, bits: int):
    s = packed.shape[1] // 2
    L, R = hashing.perm48_t(hi, lo, salt)
    bucket, tag = hashing.wide_bucket_tag_t(L, R, bits)
    row = packed[bucket].to(torch.int64) & _M32  # (..., 2*slots)
    m = row[..., :s] == tag[..., None]
    # at most one slot matches (tags are unique in a bucket): the masked
    # sum selects it, 0 on a miss
    return m.any(dim=-1), (row[..., s:] * m).sum(dim=-1) & _M32


def probe_wide_reference(hi, lo, valid, packed, ov_packed, *, salt: int,
                         bits: int, ov_salt: int, ov_bits: int,
                         has_overflow: bool, ignore_function: int = -1):
    """Plain version of probe_wide (int64 arithmetic, any device)."""
    f, fm = _tagged_match(packed, hi, lo, salt, bits)
    if has_overflow:
        f2, fm2 = _tagged_match(ov_packed, hi, lo, ov_salt, ov_bits)
        fm = torch.where(f, fm, fm2)
        f = f | f2
    found = f & valid & (((fm >> 16) & 0xFFFF) != ignore_function)
    return found, hashing.to_i32(fm)


def probe_wide(hi, lo, valid, packed, ov_packed, *, salt: int, bits: int,
               ov_salt: int, ov_bits: int, has_overflow: bool,
               ignore_function: int = -1):
    """Probe a wide table for (B, W) windows.

    hi, lo: int32 packed window words; valid: bool call mask; packed,
    ov_packed: the table's int32 rows (WideKmerTable.to_device).
    ignore_function: a function index whose hits are dropped
    (``--ignore-hypo``), or -1.  -> (found bool, fm int32), where found
    is already masked by valid and ignore_function.  The kernel reads no
    table row for an invalid window and writes fm 0 there; the plain
    version's fm is the table's everywhere, so the two agree on fm under
    valid."""
    if not cl.on_cuda(hi, lo, valid, packed, ov_packed):
        return probe_wide_reference(
            hi, lo, valid, packed, ov_packed, salt=salt, bits=bits,
            ov_salt=ov_salt, ov_bits=ov_bits, has_overflow=has_overflow,
            ignore_function=ignore_function)
    shape = tuple(hi.shape)
    cl.check(hi, "hi", torch.int32)
    cl.check(lo, "lo", torch.int32, shape)
    cl.check(valid, "valid", torch.bool, shape)
    cl.check(packed, "packed", torch.int32)
    cl.check(ov_packed, "ov_packed", torch.int32)
    for name, t in (("packed", packed), ("ov_packed", ov_packed)):
        if t.dim() != 2 or t.shape[1] % 2:
            raise ValueError(f"{name}: rows of 2*slots words expected, "
                             f"got shape {tuple(t.shape)}")
    if packed.shape[0] != 1 << bits or (
            has_overflow and ov_packed.shape[0] != 1 << ov_bits):
        raise ValueError("table row counts do not match bits/ov_bits")
    if packed.shape[1] not in (4, 8):
        raise ValueError(f"packed: the kernel takes 2 or 4 slots per row, "
                         f"got {packed.shape[1] // 2}")
    hashing.check_bits(bits)
    if has_overflow:
        hashing.check_bits(ov_bits)
    # the kernel moves 4 windows and whole main rows as 16-byte words
    cl.check_aligned(16, hi=hi, lo=lo, valid=valid, packed=packed,
                     ov_packed=ov_packed)
    found = torch.empty(shape, dtype=torch.bool, device=hi.device)
    fm = torch.empty(shape, dtype=torch.int32, device=hi.device)
    cl.launch("probe_wide",
              [hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), hi.numel(),
               packed.data_ptr(), packed.shape[1] // 2, salt & _M32, bits,
               ov_packed.data_ptr(), ov_packed.shape[1] // 2, ov_salt & _M32,
               ov_bits, int(has_overflow), ignore_function,
               found.data_ptr(), fm.data_ptr()],
              hi.device)
    probe_wide.launches += 1
    return found, fm


probe_wide.launches = 0
