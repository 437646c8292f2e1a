"""Query transfer rows and the rolling k-mer pack.

Host side: sequences go to the device 6-bit packed, 16 codes to a 96-bit
row of three uint32 words, each sequence starting on a row boundary
(pack_u6_rows_host).  Device side: pack_call_windows_rows16 reads each
sequence's rows and packs every window into two 24-bit words with the
call-side validity mask (kernel: csrc/pack_call_windows.cu).  Its plain
version is the two steps the JAX package runs: expand_rows16 gathers the
rows back into a (B, L) code matrix padded with INVALID_CODE, and
pack_call_windows_reference packs that matrix.

Outputs stay position-aligned: a window's column is its residue position,
exactly the ``offset`` the reference reports.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import alphabet
from . import cuda_launch as cl

K = alphabet.K
ALIGN = 16  # codes per transfer row: 16 codes = 96 bits = 3 uint32 words
_M24 = 0xFF_FFFF


# -- host packing -------------------------------------------------------------


def pack_u6_rows_host(codes: np.ndarray, offsets: np.ndarray, rows: int,
                      L: int):
    """Host: concatenated codes + offsets -> 16-code-aligned packed rows.

    Each sequence's codes start on a 16-code boundary (INVALID padding in
    between), 6-bit packed MSB-first into one 96-bit row of THREE uint32
    words, so the device expands the batch with row gathers.

    Returns (packed_rows (R, 3) uint32, start_row (rows,) int32,
    lengths (rows,) int32); R is padded to a pow2/1.5x grid.  start_row
    of padding rows points at a dedicated all-INVALID row.
    """
    B = offsets.shape[0] - 1
    lens = np.minimum((offsets[1:] - offsets[:-1]), L).astype(np.int32)
    spans = -(-lens // ALIGN)  # 16-code rows per sequence
    row_start = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(spans, out=row_start[1:])
    total_rows = int(row_start[-1]) + 1  # +1 all-INVALID row for padding
    R = 1 << 10
    while R < total_rows:
        R <<= 1
    if R > (1 << 10) and (R >> 1) + (R >> 2) >= total_rows:
        R = (R >> 1) + (R >> 2)
    packed = _pack_u6_rows(codes, offsets, lens, row_start, R)
    start_row = np.full(rows, total_rows - 1, dtype=np.int32)
    start_row[:B] = row_start[:-1]
    lengths = np.zeros(rows, dtype=np.int32)
    lengths[:B] = lens
    return packed, start_row, lengths


def _pack_u6_rows(codes, offsets, lens, row_start, R: int):
    from ..runtime import host

    if host.available():
        # single-pass native packer: this runs per chunk on the caller's
        # critical path
        return host.pack_u6_rows(codes, offsets, lens, row_start, R)
    return _pack_u6_rows_np(codes, offsets, lens, row_start, R)


def _pack16_np(flat: np.ndarray) -> np.ndarray:
    """Numpy: (N,) uint8 codes with N % 16 == 0 -> (N/16, 3) uint32
    MSB-first 96-bit rows (the transfer format expand_rows16 inverts)."""
    c = flat.reshape(-1, ALIGN).astype(np.uint32)
    packed = np.empty((c.shape[0], 3), dtype=np.uint32)
    packed[:, 0] = ((c[:, 0] << 26) | (c[:, 1] << 20) | (c[:, 2] << 14)
                    | (c[:, 3] << 8) | (c[:, 4] << 2) | (c[:, 5] >> 4))
    packed[:, 1] = (((c[:, 5] & 15) << 28) | (c[:, 6] << 22)
                    | (c[:, 7] << 16) | (c[:, 8] << 10) | (c[:, 9] << 4)
                    | (c[:, 10] >> 2))
    packed[:, 2] = (((c[:, 10] & 3) << 30) | (c[:, 11] << 24)
                    | (c[:, 12] << 18) | (c[:, 13] << 12) | (c[:, 14] << 6)
                    | c[:, 15])
    return packed


def _pack_u6_rows_np(codes, offsets, lens, row_start, R: int):
    """Numpy spec for the packed row format (host.pack_u6_rows must
    match byte for byte)."""
    B = lens.shape[0]
    flat = np.full(R * ALIGN, alphabet.INVALID_CODE, dtype=np.uint8)
    for b in range(B):
        s = int(offsets[b])
        d = int(row_start[b]) * ALIGN
        flat[d:d + int(lens[b])] = codes[s:s + int(lens[b])]
    return _pack16_np(flat)


# -- device expand --------------------------------------------------------------


def expand_rows16(packed_rows: torch.Tensor, start_row: torch.Tensor,
                  lengths: torch.Tensor, L: int) -> torch.Tensor:
    """Device inverse of pack_u6_rows_host: one row gather + bit unpack.

    packed_rows: (R, 3) int32 (bit container of the uint32 words);
    start_row, lengths: (B,) int32.  -> (B, L) uint8 codes, INVALID
    beyond each length, with L % 16 == 0.
    """
    nrow = L // ALIGN
    idx = (start_row.to(torch.int64)[:, None]
           + torch.arange(nrow, device=start_row.device)[None, :])
    rows = packed_rows[idx.clamp(0, packed_rows.shape[0] - 1)]
    w0, w1, w2 = (rows[..., i].to(torch.int64) & 0xFFFF_FFFF
                  for i in range(3))
    c = torch.stack([
        w0 >> 26, w0 >> 20, w0 >> 14, w0 >> 8, w0 >> 2,
        (w0 << 4) | (w1 >> 28),                      # straddles w0/w1
        w1 >> 22, w1 >> 16, w1 >> 10, w1 >> 4,
        (w1 << 2) | (w2 >> 30),                      # straddles w1/w2
        w2 >> 24, w2 >> 18, w2 >> 12, w2 >> 6, w2,
    ], dim=-1) & 63                                  # (B, nrow, 16)
    codes = c.reshape(c.shape[0], L).to(torch.uint8)
    pos = torch.arange(L, device=codes.device)[None, :]
    return torch.where(pos < lengths[:, None], codes,
                       torch.tensor(alphabet.INVALID_CODE, dtype=torch.uint8,
                                    device=codes.device))


# -- window pack of a code matrix (plain) -------------------------------------


def _shift_left(x: torch.Tensor, j: int, fill) -> torch.Tensor:
    """x shifted left by j along the last axis, padded with fill."""
    j = min(j, x.shape[1])
    pad = torch.full((x.shape[0], j), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[:, j:], pad], dim=1)


def pack_call_windows_reference(codes: torch.Tensor, lengths: torch.Tensor,
                                W: int | None = None):
    """The JAX package's pack_call_windows on a (B, L) code matrix: the XLA
    program's log-doubling shifts in int64.  -> (hi, lo) int32 and valid
    bool, each (B, W)."""
    B, L = codes.shape
    W = L if W is None else W
    c = codes.to(torch.int64)
    # 4-char words by doubling: d2[j] = c[j]c[j+1]; d4[j] = c[j..j+3]
    d2 = (c << 6) | _shift_left(c, 1, alphabet.INVALID_CODE)
    d4 = (d2 << 12) | _shift_left(d2, 2, 0)
    hi = d4 & _M24
    lo = _shift_left(d4, 4, 0) & _M24
    # call-side ambiguity: '*' or uppercase 'X' (ref: kmer_data.h:82)
    ok = (codes != alphabet.STAR_CODE) & (codes != alphabet.X_UPPER_CODE)
    w2 = ok & _shift_left(ok, 1, False)
    w4 = w2 & _shift_left(w2, 2, False)
    w8 = w4 & _shift_left(w4, 4, False)
    # K+1-wide exclusion: a window ENDING at an ambiguous char (ambig at
    # p+K) is skipped too (kmer_data.h:88-90); beyond the row the fill is
    # True, so the sequence-final window stays valid
    w9 = w8 & _shift_left(ok, K, True)
    pos = torch.arange(L, device=codes.device)[None, :]
    valid = w9 & (pos + K <= lengths[:, None])
    return (hi[:, :W].to(torch.int32), lo[:, :W].to(torch.int32),
            valid[:, :W].contiguous())


# -- fused expand + window pack: plain version + kernel wrapper ---------------


def pack_call_windows_rows16_reference(packed_rows: torch.Tensor,
                                       start_row: torch.Tensor,
                                       lengths: torch.Tensor, L: int,
                                       W: int):
    """Plain version of pack_call_windows_rows16: expand_rows16, then
    pack_call_windows_reference."""
    return pack_call_windows_reference(
        expand_rows16(packed_rows, start_row, lengths, L), lengths, W)


def pack_call_windows_rows16(packed_rows: torch.Tensor,
                             start_row: torch.Tensor, lengths: torch.Tensor,
                             L: int, W: int):
    """Transfer rows -> (hi, lo, valid) for the first W windows of each
    sequence at padded width L, without the (B, L) code matrix.

    packed_rows: (R, 3) int32 (pack_u6_rows_host's words); start_row,
    lengths: (B,) int32; L and W multiples of 16 with 0 < W <= L.  hi and
    lo are (B, W) int32 bit containers of the 24-bit words; valid is bool.
    """
    if L % ALIGN or W % ALIGN or not 0 < W <= L:
        raise ValueError(f"need L and W multiples of {ALIGN} with "
                         f"0 < W <= L, got L {L}, W {W}")
    if not cl.on_cuda(packed_rows, start_row, lengths):
        return pack_call_windows_rows16_reference(packed_rows, start_row,
                                                  lengths, L, W)
    B = start_row.shape[0]
    R = packed_rows.shape[0]
    if R == 0:
        raise ValueError("packed_rows: no rows to clamp the indices to")
    cl.check(packed_rows, "packed_rows", torch.int32, (R, 3))
    cl.check(start_row, "start_row", torch.int32, (B,))
    cl.check(lengths, "lengths", torch.int32, (B,))
    hi = torch.empty((B, W), dtype=torch.int32, device=start_row.device)
    lo = torch.empty_like(hi)
    valid = torch.empty((B, W), dtype=torch.bool, device=start_row.device)
    cl.launch("pack_call_windows",
              [packed_rows.data_ptr(), R, start_row.data_ptr(),
               lengths.data_ptr(), B, L, W, hi.data_ptr(), lo.data_ptr(),
               valid.data_ptr()],
              start_row.device)
    pack_call_windows_rows16.launches += 1
    return hi, lo, valid


pack_call_windows_rows16.launches = 0
