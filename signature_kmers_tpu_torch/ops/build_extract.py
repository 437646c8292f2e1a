"""Build-side window extraction from the 8-bit transfer rows.

The corpus goes to the device as pack_u8_rows' flat rows (every sequence
16-code aligned, INVALID padding) plus three int32 values per sequence:
its aligned start in the flat array, function index and length.
build_extract_windows returns the VALID windows only, in sequence order
and then position, as the selection pass's sort keys:

    key_f = ((kmer48 << 16) | (fidx & 0xFFFF)) ^ (1 << 63)   int64
    key_o = ((kmer48 << 16) | (off & 0xFFFF)) ^ (1 << 63)    int64
    plen, seq                                                int32

with kmer48 the packed 8-mer (hi << 24 | lo), off = length - position,
seq the window's sequence index (its row in starts), and the sign bit
flipped so that torch's signed sort orders the keys as unsigned words.
A window is valid when it lies inside its sequence and its 8 codes are
among the 20 amino acids of either case.  Kernel:
csrc/build_extract.cu; the plain version below is the JAX package's
window shifts and windowed cumsum on the same rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import alphabet
from . import cuda_launch as cl

K = alphabet.K
SIGN = -(1 << 63)  # int64 with only bit 63 set
SEQS_PER_BLOCK = 8  # csrc/build_extract.cu: a warp per sequence
# bit c set when code c is an acceptable build-side residue
AA_MASK = int(sum(1 << c for c in np.flatnonzero(alphabet.CODE_IS_AA)))


def window_keys(kmer48: torch.Tensor, low16: torch.Tensor) -> torch.Tensor:
    """((kmer48 << 16) | (low16 & 0xFFFF)) ^ (1 << 63) as int64."""
    return ((kmer48.to(torch.int64) << 16)
            | (low16.to(torch.int64) & 0xFFFF)) ^ SIGN


def key_kmer(keys: torch.Tensor) -> torch.Tensor:
    """The 48-bit k-mer of window_keys' keys (int64)."""
    return ((keys ^ SIGN) >> 16) & 0xFFFF_FFFF_FFFF


def build_extract_windows_reference(codes: torch.Tensor,
                                    starts: torch.Tensor,
                                    fidx: torch.Tensor, plen: torch.Tensor):
    """Plain version of build_extract_windows: the window shifts and the
    windowed cumsum of the all-amino-acid test over the flat rows, then
    the valid windows of each sequence in order."""
    dev = codes.device
    n = codes.shape[0]
    c = codes.to(torch.int64)
    flat = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    flat[1:] = torch.cumsum(
        torch.from_numpy(alphabet.CODE_IS_AA).to(dev)[c].to(torch.int64), 0)
    p64 = plen.to(torch.int64)
    nwin = (p64 - (K - 1)).clamp(min=0)
    first = torch.cumsum(nwin, 0) - nwin
    seq = torch.repeat_interleave(torch.arange(plen.shape[0], device=dev),
                                  nwin)
    p = torch.arange(int(nwin.sum()), device=dev) - first[seq]
    pos = starts.to(torch.int64)[seq] + p
    keep = (flat[pos + K] - flat[pos]) == K
    pos, seq, p = pos[keep], seq[keep], p[keep]
    kmer = torch.zeros_like(pos)
    for j in range(K):
        kmer = (kmer << 6) | c[pos + j]
    return (window_keys(kmer, fidx[seq]),
            window_keys(kmer, p64[seq] - p),
            plen[seq].contiguous(), seq.to(torch.int32))


def build_extract_windows(codes: torch.Tensor, starts: torch.Tensor,
                          fidx: torch.Tensor, plen: torch.Tensor):
    """Flat 8-bit rows + per-sequence (start, fidx, plen) -> the valid
    windows' (key_f, key_o, plen, seq) (module docstring).

    codes: (R*16,) uint8 (pack_u8_rows); starts, fidx, plen: (B,) int32,
    each start the sequence's 16-aligned offset in codes, the spans
    disjoint, and the codes past each length INVALID up to the next row
    boundary.  On the card the outputs are sized R*16, which disjoint
    spans make at least sum(max(plen - 7, 0)), and the valid count is
    read back once, at the end, to cut them to it."""
    if not cl.on_cuda(codes, starts, fidx, plen):
        return build_extract_windows_reference(codes, starts, fidx, plen)
    B = starts.shape[0]
    cl.check(codes, "codes", torch.uint8, (codes.shape[0],))
    if codes.shape[0] % 16:
        raise ValueError("codes: a whole number of 16-code rows expected")
    cl.check_aligned(16, codes=codes)
    for name, t in (("starts", starts), ("fidx", fidx), ("plen", plen)):
        cl.check(t, name, torch.int32, (B,))
    dev = codes.device
    cap = codes.shape[0]
    outs = (torch.empty(cap, dtype=torch.int64, device=dev),
            torch.empty(cap, dtype=torch.int64, device=dev),
            torch.empty(cap, dtype=torch.int32, device=dev),
            torch.empty(cap, dtype=torch.int32, device=dev))
    if B == 0:
        return tuple(o[:0] for o in outs)
    scratch = extract_scratch(B, dev)
    launch_extract(codes, starts, fidx, plen, outs, scratch)
    build_extract_windows.launches += 1
    N = int(scratch[1])
    if N > cap:
        raise ValueError(f"the {N} valid windows exceed the {cap} codes: "
                         f"the sequences' spans overlap")
    return tuple(o[:N] for o in outs)


build_extract_windows.launches = 0


def extract_scratch(B: int, device) -> torch.Tensor:
    """build_extract_windows' zeroed scratch: tile ids, the valid count,
    then a look-back status word per tile of SEQS_PER_BLOCK sequences
    (csrc/lookback.cuh).  The entry point refuses a shorter one."""
    return torch.zeros(2 + -(-B // SEQS_PER_BLOCK), dtype=torch.int64,
                       device=device)


def launch_extract(codes, starts, fidx, plen, outs, scratch) -> None:
    """The kernel's launch into the four given outputs (each of
    outs[0].shape[0] windows, the cap past which it stores nothing) and
    zeroed scratch (the wrapper's, and its timing alone); the count is
    scratch[1]."""
    cl.launch("build_extract_windows",
              [codes.data_ptr(), starts.data_ptr(), fidx.data_ptr(),
               plen.data_ptr(), starts.shape[0], AA_MASK, outs[0].shape[0],
               *(o.data_ptr() for o in outs), scratch.data_ptr(),
               scratch.shape[0]], codes.device)
