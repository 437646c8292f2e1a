"""Calling automaton over probe hits, and the packed per-row result block
(kernel: csrc/automaton.cu, which fuses the automaton and the packing).

Pass A walks each sequence's window positions with O(1) state: gap flush
(max_gap), fresh-buffer adopt, keep-last-two function switch, tail flush
(ref: call_functions.tcc:259-338).  A buffer's hits always form a
contiguous position interval, so each flush is one record
(function, first position, last position); the first REC_CAP records are
kept and all are counted.

Pass B, per record: members are hits in the interval with the record's
function; the exact median and MAD of their stored mean lengths
(ref: HitSet::process, call_functions.tcc:35-103) come from a counting
binary search over the 16/18-bit value range, then the min-hits and
float32 length-window test.

pack_records folds the result into 1 + 3*REC_CAP int32 words per row.
Rows whose records do not fit 16-bit fields exactly, or that overflow
REC_CAP, carry n_recs > REC_CAP and are re-called exactly on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_launch as cl
from .hashing import to_i32

REC_CAP = 4          # record slots per sequence (overflow -> host fallback)
PACKED_WORDS = 1 + 3 * REC_CAP
UNDEF = 0xFFFF


def _pass_a(found, func, min_hits: int, max_gap: int):
    """Pass A, one row at a time over its hits in order, in Python ints
    (on the host whatever the device) -> n_recs (B,) int32 and the first
    REC_CAP records' function, first and last position (int32, 0 in empty
    slots) and a valid mask, (B, REC_CAP), on found's device."""
    B = found.shape[0]
    recs = np.zeros((3, B, REC_CAP), np.int32)
    n_recs = np.zeros(B, np.int32)
    found_np, func_np = found.cpu().numpy(), func.cpu().numpy()
    for b in range(B):
        pos = np.flatnonzero(found_np[b])
        cur, n, first, lpos = UNDEF, 0, 0, -(1 << 30)
        lfunc, l2func, l2pos = UNDEF, UNDEF, 0
        out = []
        for p, f in zip(pos.tolist(), func_np[b, pos].tolist()):
            # 1. gap flush (before append; ref tcc:295-301)
            if n > 0 and lpos + max_gap < p:
                if n >= min_hits:
                    out.append((cur, first, lpos))
                    if n >= 2 and l2func != cur and l2func == lfunc:
                        cur, first, n = lfunc, l2pos, 2
                    else:
                        n = 0
                else:
                    n = 0
            if n == 0:  # 2. empty buffer adopts the hit's function
                cur, first = f, p
            l2func, l2pos, lfunc, lpos = lfunc, lpos, f, p  # 3. append
            n += 1
            # 4. same-function-pair switch (ref tcc:320-327)
            if n > 1 and cur != f and l2func == f:
                out.append((cur, first, p))
                cur, first, n = f, l2pos, 2
        if n >= min_hits:  # tail flush (ref tcc:336-337)
            out.append((cur, first, lpos))
        n_recs[b] = len(out)
        for r, rec in enumerate(out[:REC_CAP]):
            recs[:, b, r] = rec
    valid = np.arange(REC_CAP)[None, :] < n_recs[:, None]
    return tuple(torch.from_numpy(a).to(found.device)
                 for a in (n_recs, *recs, valid))


def device_automaton_reference(found, fm, seqlen, min_hits: int,
                               max_gap: int, k: int, mad_floor: float = 30.0,
                               len_window: float = 2.0):
    """Plain version of the automaton (the XLA program's arithmetic; pass
    A walks each row's hits in order on the host).

    found: (B, W) bool; fm: (B, W) int32 (function<<16 | mean);
    seqlen: (B,) int32.  Returns a dict of (B, REC_CAP) tensors:
    call_valid bool, start/end/count/fI/median int32, mad float32, plus
    n_recs (B,) int32 (> REC_CAP -> row incomplete)."""
    B, W = found.shape
    dev = found.device
    fm64 = fm.to(torch.int64) & 0xFFFF_FFFF
    func = ((fm64 >> 16) & 0xFFFF).to(torch.int32)
    mean = (fm64 & 0xFFFF).to(torch.int32)
    where = torch.where

    n_recs, rec_fI, rec_ps, rec_pe, rec_valid = _pass_a(found, func,
                                                        min_hits, max_gap)

    # ---- pass B: per-record statistics via broadcast masks ---------------
    pos = torch.arange(W, device=dev, dtype=torch.int32)[None, None, :]
    member = (found[:, None, :]
              & (pos >= rec_ps[:, :, None]) & (pos <= rec_pe[:, :, None])
              & (func[:, None, :] == rec_fI[:, :, None])
              & rec_valid[:, :, None])
    cnt = member.sum(dim=2).to(torch.int32)
    msum = where(member, mean[:, None, :], 0).sum(dim=2).to(torch.int32)

    def kth_pair(vals3, k1, k2, bits):
        # x1 = the k1-th smallest member value, x2 = the k2-th (k2 <= k1+1)
        lo = torch.zeros_like(k1)
        hi = torch.full_like(k1, (1 << bits) - 1)
        for _ in range(bits):
            mid = (lo + hi) >> 1
            n_le = (member & (vals3 <= mid[:, :, None])).sum(dim=2)
            ge = n_le >= k1
            hi = where(ge, mid, hi)
            lo = where(ge, lo, mid + 1)
        x1 = hi
        n_le1 = (member & (vals3 <= x1[:, :, None])).sum(dim=2)
        x_next = where(member & (vals3 > x1[:, :, None]), vals3,
                       1 << 30).amin(dim=2)
        return x1, where(n_le1 >= k2, x1, x_next)

    safe_cnt = cnt.clamp(min=1)
    lo_k = (safe_cnt - 1) // 2 + 1
    hi_k = safe_cnt // 2 + 1
    mean3 = mean[:, None, :].expand(member.shape)
    med_lo, med_hi = kth_pair(mean3, lo_k, hi_k, 16)
    med2 = med_lo + med_hi  # exact 2*median
    median = med2.to(torch.float32) / 2.0

    dev2 = (2 * mean3 - med2[:, :, None]).abs()  # exact 2*|mean - median|
    d2_lo, d2_hi = kth_pair(dev2, lo_k, hi_k, 18)
    mad = (d2_lo + d2_hi).to(torch.float32) / 4.0
    mad = where(mad == 0.0, torch.tensor(mad_floor, dtype=torch.float32,
                                         device=dev), mad)

    mean_len = msum.to(torch.float32) / safe_cnt.to(torch.float32)
    sl = seqlen.to(torch.float32)[:, None]
    in_window = ((sl >= mean_len - len_window * mad)
                 & (sl <= mean_len + len_window * mad))
    emit = rec_valid & (cnt >= min_hits) & in_window
    last_match_pos = where(member, pos, -1).amax(dim=2)

    return {
        "call_valid": emit,
        "start": rec_ps,
        "end": last_match_pos + (k - 1),
        "count": cnt,
        "fI": rec_fI,
        "median": median.to(torch.int32),
        "mad": mad,
        "n_recs": n_recs,
    }


def pack_records_reference(out, lengths):
    """(B, PACKED_WORDS) int32: [n_recs | start<<16|end x C |
    count<<16|fI x C | median<<16|mad*4 x C].  Invalid slots are zero
    (count == 0 marks them: every emitted record has count >= 1)."""
    valid = out["call_valid"]
    mad4f = out["mad"] * 4.0
    # exactness guards -> host fallback: sequence too long for 16-bit
    # positions/counts, mad*4 not integral (custom mad_floor) or too wide
    bad = (lengths.to(torch.int32) > 65535) | (
        valid & ((mad4f > 65535.0) | (torch.round(mad4f) != mad4f))).any(dim=1)
    mad4 = torch.round(mad4f.clamp(0.0, 65535.0)).to(torch.int32)
    n_recs = torch.where(bad, REC_CAP + 1, out["n_recs"]).to(torch.int32)

    def u16pair(hi, lo):
        w = (((hi.to(torch.int64) & 0xFFFF) << 16)
             | (lo.to(torch.int64) & 0xFFFF))
        return to_i32(torch.where(valid, w, 0))

    return torch.cat([
        n_recs[:, None],
        u16pair(out["start"], out["end"]),
        u16pair(out["count"], out["fI"]),
        u16pair(out["median"], mad4),
    ], dim=1)


def device_automaton_packed(found, fm, lengths, min_hits: int, max_gap: int,
                            k: int, mad_floor: float = 30.0,
                            len_window: float = 2.0):
    """Automaton + packing: (B, W) found bool and fm int32, (B,) int32
    lengths -> (B, PACKED_WORDS) int32 (see pack_records_reference)."""
    if not cl.on_cuda(found, fm, lengths):
        return pack_records_reference(
            device_automaton_reference(found, fm, lengths, min_hits, max_gap,
                                       k, mad_floor, len_window), lengths)
    B, W = found.shape
    cl.check(found, "found", torch.bool)
    cl.check(fm, "fm", torch.int32, (B, W))
    cl.check(lengths, "lengths", torch.int32, (B,))
    out = torch.empty((B, PACKED_WORDS), dtype=torch.int32,
                      device=found.device)
    cl.launch("device_automaton_packed",
              [found.data_ptr(), fm.data_ptr(), lengths.data_ptr(), B, W,
               min_hits, max_gap, k, float(np.float32(mad_floor)),
               float(np.float32(len_window)), out.data_ptr()],
              found.device)
    device_automaton_packed.launches += 1
    return out


device_automaton_packed.launches = 0


def unpack_records(m: np.ndarray):
    """Inverse of the packing on the host: (B, PACKED_WORDS) int32 ->
    dict of (B, REC_CAP) arrays matching the automaton's output."""
    C = REC_CAP
    u = np.ascontiguousarray(m[:, 1:]).view(np.uint32)
    se = u[:, :C]
    cf = u[:, C:2 * C]
    mm = u[:, 2 * C:3 * C]
    count = (cf >> 16).astype(np.int32)
    return {
        "n_recs": m[:, 0],
        "call_valid": count > 0,
        "start": (se >> 16).astype(np.int32),
        "end": (se & 0xFFFF).astype(np.int32),
        "count": count,
        "fI": (cf & 0xFFFF).astype(np.int32),
        "median": (mm >> 16).astype(np.int32),
        "mad": (mm & 0xFFFF).astype(np.float32) / 4.0,
    }
