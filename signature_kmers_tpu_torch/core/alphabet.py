"""Amino-acid alphabet and 6-bit k-mer codec.

TPU-native representation of protein k-mers.  The reference stores a k-mer as
raw ``std::array<char, 8>`` (ref: kmer_data.h:36-37) and is therefore
case-sensitive ('mklv...' != 'MKLV...').  We preserve that exactly with a
6-bit per-character code:

    'A'..'Z' -> 0..25        'a'..'z' -> 26..51        '*' -> 52
    anything else -> 63 (INVALID_CODE)

Eight 6-bit codes = 48 bits.  To stay in TPU-native 32-bit integer land
(int64 is emulated on TPU), a k-mer is packed into TWO uint32 words of
4 characters / 24 bits each:

    hi = c0<<18 | c1<<12 | c2<<6 | c3
    lo = c4<<18 | c5<<12 | c6<<6 | c7

Both words use only the low 24 bits, so 0xFFFFFFFF is free as an
empty-slot / padding sentinel.

Validity rules (the two rules genuinely differ in the reference):

- build-side: every character of the window must be one of the 20 amino
  acids, either case (ref: signature_build.h:102-103, signature_build.tcc:162-180).
- call-side: the window must not contain '*' or uppercase 'X'
  (ref: kmer_data.h:76-102 ``for_each_kmer``); any other letter (including
  lowercase 'x', 'B', 'J', ...) is still looked up.
"""

from __future__ import annotations

import numpy as np

K = 8  # ref: kmers-build-signatures.cc:17 (const int K = 8)

INVALID_CODE = 63
STAR_CODE = 52
X_UPPER_CODE = ord("X") - ord("A")  # 23

# ---------------------------------------------------------------------------
# byte -> code table (host side, numpy)
# ---------------------------------------------------------------------------

BYTE_TO_CODE = np.full(256, INVALID_CODE, dtype=np.uint8)
for _c in range(ord("A"), ord("Z") + 1):
    BYTE_TO_CODE[_c] = _c - ord("A")
for _c in range(ord("a"), ord("z") + 1):
    BYTE_TO_CODE[_c] = _c - ord("a") + 26
BYTE_TO_CODE[ord("*")] = STAR_CODE

CODE_TO_BYTE = np.full(64, ord("?"), dtype=np.uint8)
for _c in range(ord("A"), ord("Z") + 1):
    CODE_TO_BYTE[_c - ord("A")] = _c
for _c in range(ord("a"), ord("z") + 1):
    CODE_TO_BYTE[_c - ord("a") + 26] = _c
CODE_TO_BYTE[STAR_CODE] = ord("*")

# The 20 standard amino acids, upper case (ref: signature_build.h:102-103).
AA20 = "ACDEFGHIKLMNPQRSTVWY"

# code -> is an acceptable build-side residue (both cases)
CODE_IS_AA = np.zeros(64, dtype=bool)
for _ch in AA20:
    CODE_IS_AA[ord(_ch) - ord("A")] = True
    CODE_IS_AA[ord(_ch.lower()) - ord("a") + 26] = True

# code -> terminates a call-side window ('*' or uppercase 'X' only;
# ref: kmer_data.h:82)
CODE_IS_CALL_AMBIG = np.zeros(64, dtype=bool)
CODE_IS_CALL_AMBIG[STAR_CODE] = True
CODE_IS_CALL_AMBIG[X_UPPER_CODE] = True


def encode_seq(seq: str | bytes) -> np.ndarray:
    """Encode a protein string into uint8 6-bit codes."""
    if isinstance(seq, str):
        seq = seq.encode("latin-1")
    return BYTE_TO_CODE[np.frombuffer(seq, dtype=np.uint8)]


def decode_codes(codes: np.ndarray) -> str:
    return CODE_TO_BYTE[np.asarray(codes, dtype=np.uint8) & 63].tobytes().decode("latin-1")


def pack_kmer_str(kmer: str) -> tuple[int, int]:
    """Pack an 8-character k-mer string into (hi, lo) uint32 words."""
    c = encode_seq(kmer)
    if c.shape[0] != K:
        raise ValueError(f"k-mer must have length {K}, got {len(kmer)}")
    hi = (int(c[0]) << 18) | (int(c[1]) << 12) | (int(c[2]) << 6) | int(c[3])
    lo = (int(c[4]) << 18) | (int(c[5]) << 12) | (int(c[6]) << 6) | int(c[7])
    return hi, lo


def unpack_kmer(hi: int, lo: int) -> str:
    codes = [
        (hi >> 18) & 63, (hi >> 12) & 63, (hi >> 6) & 63, hi & 63,
        (lo >> 18) & 63, (lo >> 12) & 63, (lo >> 6) & 63, lo & 63,
    ]
    return decode_codes(np.array(codes, dtype=np.uint8))


def pack_codes_np(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized rolling pack: codes (N,) uint8 -> (hi, lo) for every window.

    Returns arrays of length max(N - K + 1, 0); window i covers codes[i:i+8].
    """
    n = codes.shape[0]
    if n < K:
        z = np.zeros(0, dtype=np.uint32)
        return z, z
    c = codes.astype(np.uint32)
    hi = (c[0:n-7] << 18) | (c[1:n-6] << 12) | (c[2:n-5] << 6) | c[3:n-4]
    lo = (c[4:n-3] << 18) | (c[5:n-2] << 12) | (c[6:n-1] << 6) | c[7:n]
    return hi, lo
