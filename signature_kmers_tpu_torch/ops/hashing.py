"""32-bit mixing hash and the invertible 48-bit key permutation.

numpy versions (uint32, wrapping multiplies) serve the host table build
and the host probe; the torch versions serve the plain probe
(ops/probe.py) on any device.  Torch has no usable uint32 shifts on the
CPU, so the torch versions carry 32-bit words in int64 and mask; each
multiply is split into 16-bit halves so no intermediate leaves int64.

The wide table stores a <=31-bit tag per slot instead of the full 48-bit
key: a 3-round Feistel network over the two 24-bit key halves is a
bijection of the 48-bit key space, so any full-entropy (bucket, tag)
split of the permuted pair identifies the key exactly.
"""

from __future__ import annotations

import numpy as np
import torch

_C1 = 0x85EB_CA6B
_C2 = 0xC2B2_AE35
_GOLDEN = 0x9E37_79B9
_ROUND = (0x9E37_79B9, 0x85EB_CA6B, 0xC2B2_AE35)
_M24 = 0xFF_FFFF
_M32 = 0xFFFF_FFFF


def fmix32(x):
    """Murmur3 32-bit finalizer (public-domain bit-mix constants)."""
    x = np.asarray(x, dtype=np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(_C1)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(_C2)
    x = x ^ (x >> np.uint32(16))
    return x


def hash_kmer(hi, lo):
    """Mix the two 24-bit key words into a uint32 hash."""
    hi = np.asarray(hi, dtype=np.uint32)
    lo = np.asarray(lo, dtype=np.uint32)
    return fmix32(hi ^ (fmix32(lo) + np.uint32(_GOLDEN)))


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def perm48(hi, lo, salt: int):
    """Injective permutation of a 48-bit key given as two 24-bit words."""
    L = np.asarray(hi, dtype=np.uint32) & np.uint32(_M24)
    R = np.asarray(lo, dtype=np.uint32) & np.uint32(_M24)
    s = np.uint32(salt)
    for rc in _ROUND:
        F = fmix32(R ^ (s ^ np.uint32(rc))) & np.uint32(_M24)
        L, R = R, L ^ F
    return L, R


def perm48_inv(L, R, salt: int):
    """Inverse of perm48: recover (hi, lo) from the permuted halves."""
    L = np.asarray(L, dtype=np.uint32)
    R = np.asarray(R, dtype=np.uint32)
    s = np.uint32(salt)
    for rc in reversed(_ROUND):
        F = fmix32(L ^ (s ^ np.uint32(rc))) & np.uint32(_M24)
        L, R = R ^ F, L
    return L, R


def wide_bucket_tag(L, R, bits: int):
    """Split permuted halves into (bucket, tag) covering all 48 bits.

    bits = log2(bucket count), 17 <= bits <= 30: the tag has 48-bits
    width (<= 31 bits), so the uint32 empty-slot sentinel 0xFFFFFFFF can
    never be a valid tag, for stored keys AND for arbitrary queries.
    (bucket, tag) <-> (L, R) is a bijection.
    """
    check_bits(bits)
    if bits <= 24:
        bucket = R & np.uint32((1 << bits) - 1)
        tag = (L << np.uint32(24 - bits)) | (R >> np.uint32(bits))
    else:
        bucket = ((L & np.uint32((1 << (bits - 24)) - 1)) << np.uint32(24)) | R
        tag = L >> np.uint32(bits - 24)
    return bucket, tag


def check_bits(bits: int) -> None:
    if not 17 <= bits <= 30:
        raise ValueError(f"wide table bits {bits} outside [17, 30]")


# -- torch versions: 32-bit words held in int64 ------------------------------


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit word -> int32 with the same bits."""
    return (((x & _M32) + (1 << 31)) & _M32).sub_(1 << 31).to(torch.int32)


def _mul32_t(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for 0 <= x < 2**32, without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def fmix32_t(x: torch.Tensor) -> torch.Tensor:
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32_t(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32_t(x, _C2)
    return x ^ (x >> 16)


def hash_kmer_t(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """torch hash_kmer: 32-bit words in any integer dtype -> int64 hash."""
    hi = hi.to(torch.int64) & _M32
    lo = lo.to(torch.int64) & _M32
    return fmix32_t(hi ^ ((fmix32_t(lo) + _GOLDEN) & _M32))


def perm48_t(hi: torch.Tensor, lo: torch.Tensor, salt: int):
    """torch perm48: int64 tensors in, int64 (L, R) 24-bit halves out."""
    L = hi.to(torch.int64) & _M24
    R = lo.to(torch.int64) & _M24
    for rc in _ROUND:
        F = fmix32_t(R ^ ((salt ^ rc) & _M32)) & _M24
        L, R = R, L ^ F
    return L, R


def wide_bucket_tag_t(L: torch.Tensor, R: torch.Tensor, bits: int):
    """torch wide_bucket_tag on int64 halves -> int64 (bucket, tag)."""
    check_bits(bits)
    if bits <= 24:
        bucket = R & ((1 << bits) - 1)
        tag = ((L << (24 - bits)) | (R >> bits)) & _M32
    else:
        bucket = ((L & ((1 << (bits - 24)) - 1)) << 24) | R
        tag = L >> (bits - 24)
    return bucket, tag


def bucket_hashes_t(hi: torch.Tensor, lo: torch.Tensor, salt: int,
                    n_buckets: int):
    """torch table/bucket_table.bucket_hashes: the two cuckoo buckets of
    each key, int64."""
    hi = hi.to(torch.int64) & _M32
    lo = lo.to(torch.int64) & _M32
    s = salt & _M32
    mask = n_buckets - 1
    h1 = fmix32_t(hi ^ fmix32_t(lo ^ s))
    h2 = fmix32_t(lo ^ fmix32_t(hi ^ ((s + _GOLDEN) & _M32)))
    return h1 & mask, h2 & mask


def jenkins_mix_t(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """torch interop/hashes.jenkins_mix (Bob Jenkins' mix, cmph
    jenkins.c) on 32-bit words held in int64."""
    a = ((a - b - c) & _M32) ^ (c >> 13)
    b = ((b - c - a) & _M32) ^ ((a << 8) & _M32)
    c = ((c - a - b) & _M32) ^ (b >> 13)
    a = ((a - b - c) & _M32) ^ (c >> 12)
    b = ((b - c - a) & _M32) ^ ((a << 16) & _M32)
    c = ((c - a - b) & _M32) ^ (b >> 5)
    a = ((a - b - c) & _M32) ^ (c >> 3)
    b = ((b - c - a) & _M32) ^ ((a << 10) & _M32)
    c = ((c - a - b) & _M32) ^ (b >> 15)
    return a, b, c
