"""Wide-table probes: per window one main row read (beside it an aux row
for the value words), and on a main-row miss one read of the small
overflow leaf (kernels: csrc/probe_wide.cu).

The table (table/wide_table.py) stores per bucket ``slots`` (tag, fm)
pairs; fm = function<<16 | mean.  A window's 48-bit key is permuted
(ops/hashing.perm48), split into (bucket, tag), and matched against the
bucket's tags; the overflow leaf is searched the same way with its own
salt and bits when the build had overflow keys.

probe_wide probes the (hi, lo, valid) words that pack_call_windows_rows16
wrote (the call path).  The two others read the transfer rows themselves,
with the pack fused in: probe_wide_aux returns the matched slot's three
value words from the ``aux`` rows (v0 x slots, v1 x slots, v2 x slots)
with the probe (gather_hits_batch, --debug-hits); probe_wide_distance
applies the matrix-distance filters, reading one distance row per window
(wide_table.distance_rows), and returns the found mask alone.  The plain
version of each fused one is the pack's plain version, then the lookup's
(lookup_aux_reference, lookup_distance_reference) on the same rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..table.wide_table import aux_row_words, distance_row_words
from . import cuda_launch as cl
from . import hashing, kmer_pack

_M32 = 0xFFFF_FFFF


def _tagged_match(packed: torch.Tensor, hi, lo, salt: int, bits: int):
    """-> (bucket, slot match mask, found, fm) of one tagged store."""
    s = packed.shape[1] // 2
    L, R = hashing.perm48_t(hi, lo, salt)
    bucket, tag = hashing.wide_bucket_tag_t(L, R, bits)
    row = packed[bucket].to(torch.int64) & _M32  # (..., 2*slots)
    m = row[..., :s] == tag[..., None]
    # at most one slot matches (tags are unique in a bucket): the masked
    # sum selects it, 0 on a miss
    return bucket, m, m.any(dim=-1), (row[..., s:] * m).sum(dim=-1) & _M32


def _aux_words(aux: torch.Tensor, bucket, m):
    """The matched slot's (v0, v1, v2) from the aux rows (3*slots words,
    then any padding), 0 on a miss."""
    s = m.shape[-1]
    row = aux[bucket].to(torch.int64) & _M32  # (..., >= 3*slots)
    return tuple((row[..., k * s:(k + 1) * s] * m).sum(dim=-1) & _M32
                 for k in range(3))


def _probe(hi, lo, packed, ov_packed, aux, ov_aux, salt, bits, ov_salt,
           ov_bits, has_overflow):
    """Main row, then the leaf: (match, fm[, v0, v1, v2]) as int64."""
    b, m, f, fm = _tagged_match(packed, hi, lo, salt, bits)
    words = () if aux is None else _aux_words(aux, b, m)
    if has_overflow:
        b2, m2, f2, fm2 = _tagged_match(ov_packed, hi, lo, ov_salt, ov_bits)
        fm = torch.where(f, fm, fm2)
        if aux is not None:
            words = tuple(torch.where(f, a, w) for a, w in
                          zip(words, _aux_words(ov_aux, b2, m2)))
        f = f | f2
    return (f, fm) + words


def probe_wide_reference(hi, lo, valid, packed, ov_packed, *, salt: int,
                         bits: int, ov_salt: int, ov_bits: int,
                         has_overflow: bool, ignore_function: int = -1):
    """Plain version of probe_wide (int64 arithmetic, any device)."""
    f, fm = _probe(hi, lo, packed, ov_packed, None, None, salt, bits,
                   ov_salt, ov_bits, has_overflow)
    found = f & valid & (((fm >> 16) & 0xFFFF) != ignore_function)
    return found, hashing.to_i32(fm)


def _check_tables(packed, ov_packed, aux, ov_aux, bits, ov_bits,
                  has_overflow):
    tables = dict(packed=packed, ov_packed=ov_packed)
    if aux is not None:
        tables.update(aux=aux, ov_aux=ov_aux)
    for name, t in tables.items():
        cl.check(t, name, torch.int32)
        if t.dim() != 2 or name.endswith("packed") and t.shape[1] % 2:
            raise ValueError(f"{name}: rows of 2*slots words expected, got "
                             f"shape {tuple(t.shape)}")
    if packed.shape[0] != 1 << bits or (
            has_overflow and ov_packed.shape[0] != 1 << ov_bits):
        raise ValueError("table row counts do not match bits/ov_bits")
    if packed.shape[1] not in (4, 8):
        raise ValueError(f"packed: the kernel takes 2 or 4 slots per row, "
                         f"got {packed.shape[1] // 2}")
    if aux is not None and (
            aux.shape != (packed.shape[0],
                          aux_row_words(packed.shape[1] // 2))
            or ov_aux.shape != (ov_packed.shape[0],
                                ov_packed.shape[1] // 2 * 3)):
        raise ValueError("aux rows must be beside each probe row: the main "
                         "store's padded to aux_row_words(slots) words, the "
                         "leaf's of 3*slots words (WideKmerTable."
                         "aux_to_device)")
    hashing.check_bits(bits)
    if has_overflow:
        hashing.check_bits(ov_bits)
    # the kernels read whole main rows as 16-byte words, aux rows as 8- or
    # 16-byte words
    cl.check_aligned(16, **tables)


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
    _check_tables(packed, ov_packed, None, None, bits, ov_bits,
                  has_overflow)
    cl.check_aligned(16, hi=hi, lo=lo, valid=valid)
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


# -- the probe with value words, transfer rows in ---------------------------


def lookup_aux_reference(hi, lo, valid, packed, ov_packed, aux, ov_aux, *,
                         salt: int, bits: int, ov_salt: int, ov_bits: int,
                         has_overflow: bool):
    """Plain aux lookup of (hi, lo, valid) windows (int64 arithmetic, any
    device) -> (found bool, fm, r0, r1, r2 int32), found masked by valid;
    the words are the table's wherever a key matched."""
    f, fm, r0, r1, r2 = _probe(hi, lo, packed, ov_packed, aux, ov_aux, salt,
                               bits, ov_salt, ov_bits, has_overflow)
    return (f & valid,) + tuple(hashing.to_i32(w) for w in (fm, r0, r1, r2))


def probe_wide_aux_reference(t_rows, start_row, lengths, L: int, W: int,
                             packed, ov_packed, aux, ov_aux, *, salt: int,
                             bits: int, ov_salt: int, ov_bits: int,
                             has_overflow: bool):
    """Plain version of probe_wide_aux: the pack's plain version, then
    lookup_aux_reference."""
    hi, lo, valid = kmer_pack.pack_call_windows_rows16_reference(
        t_rows, start_row, lengths, L, W)
    return lookup_aux_reference(hi, lo, valid, packed, ov_packed, aux,
                                ov_aux, salt=salt, bits=bits,
                                ov_salt=ov_salt, ov_bits=ov_bits,
                                has_overflow=has_overflow)


def probe_wide_aux(t_rows, start_row, lengths, L: int, W: int, packed,
                   ov_packed, aux, ov_aux, *, salt: int, bits: int,
                   ov_salt: int, ov_bits: int, has_overflow: bool):
    """The first W windows of each sequence of transfer rows probed, with
    the matched slot's three value words.

    t_rows, start_row, lengths, L, W: as pack_call_windows_rows16 takes
    them; packed, ov_packed, aux, ov_aux: the table's int32 probe and aux
    rows (WideKmerTable.to_device(with_aux=True): the main store's aux
    rows padded to aux_row_words(slots) words).  -> (found bool, fm,
    r0, r1, r2 int32), each (B, W), found masked by the call mask only.
    The kernel reads no table row for an invalid window and writes 0
    where nothing matched; the plain version's words are the table's
    wherever a key matched, so the two agree on fm and r* under found."""
    kmer_pack.check_widths(L, W)
    if not cl.on_cuda(t_rows, start_row, lengths, packed, ov_packed, aux,
                      ov_aux):
        return probe_wide_aux_reference(
            t_rows, start_row, lengths, L, W, packed, ov_packed, aux,
            ov_aux, salt=salt, bits=bits, ov_salt=ov_salt, ov_bits=ov_bits,
            has_overflow=has_overflow)
    B, R = kmer_pack.check_rows(t_rows, start_row, lengths)
    _check_tables(packed, ov_packed, aux, ov_aux, bits, ov_bits,
                  has_overflow)
    dev = t_rows.device
    found = torch.empty((B, W), dtype=torch.bool, device=dev)
    words = [torch.empty((B, W), dtype=torch.int32, device=dev)
             for _ in range(4)]
    cl.launch("probe_wide_aux",
              [t_rows.data_ptr(), R, start_row.data_ptr(),
               lengths.data_ptr(), B, L, W, packed.data_ptr(),
               packed.shape[1] // 2, salt & _M32, bits, aux.data_ptr(),
               ov_packed.data_ptr(), ov_packed.shape[1] // 2, ov_salt & _M32,
               ov_bits, int(has_overflow), ov_aux.data_ptr(),
               found.data_ptr(), *(w.data_ptr() for w in words)],
              dev)
    probe_wide_aux.launches += 1
    return (found, *words)


probe_wide_aux.launches = 0


# -- the distance mask, transfer rows in --------------------------------------


def _exact_length_form(len_sigma_window: float,
                       zero_var_len_frac: float) -> bool:
    """The reference's defaults have an exact integer form of the filter
    (models/matrix_distance.py in the JAX package)."""
    return len_sigma_window == 2.0 and zero_var_len_frac == 0.1


def _distance_match(drows: torch.Tensor, S: int, hi, lo, salt: int,
                    bits: int):
    """-> (found, fm, var16) of one store's distance rows, as int64."""
    L, R = hashing.perm48_t(hi, lo, salt)
    bucket, tag = hashing.wide_bucket_tag_t(L, R, bits)
    row = drows[bucket].to(torch.int64) & _M32  # (..., D)
    m = row[..., :S] == tag[..., None]
    var = torch.stack([(row[..., 2 * S + s // 2] >> (16 * (s & 1))) & 0xFFFF
                       for s in range(S)], dim=-1)
    return (m.any(dim=-1), (row[..., S:2 * S] * m).sum(dim=-1) & _M32,
            (var * m).sum(dim=-1))


def lookup_distance_reference(hi, lo, valid, lengths, drows, ov_drows, *,
                              slots: int, ov_slots: int, salt: int,
                              bits: int, ov_salt: int, ov_bits: int,
                              has_overflow: bool, hypo: int,
                              len_sigma_window: float,
                              zero_var_len_frac: float):
    """Plain distance mask of (hi, lo, valid) windows from the distance
    rows (any device)."""
    f, fm, var = _distance_match(drows, slots, hi, lo, salt, bits)
    if has_overflow:
        f2, fm2, var2 = _distance_match(ov_drows, ov_slots, hi, lo, ov_salt,
                                        ov_bits)
        fm = torch.where(f, fm, fm2)
        var = torch.where(f, var, var2)
        f = f | f2
    func = fm >> 16
    mean = (fm & 0xFFFF).to(torch.int32)
    var = var.to(torch.int32)
    seqlen = lengths.to(torch.int32)[:, None]
    d = seqlen - mean
    if _exact_length_form(len_sigma_window, zero_var_len_frac):
        # |d| <= 2*sqrt(var) <=> d^2 <= 4*var (|d| past 1024 fails anyway:
        # 4*var <= 262140); var == 0: |d| <= 0.2*seqlen <=> 5|d| <= seqlen
        dc = torch.clamp(d.abs(), max=1024)
        okl = torch.where(var == 0, 5 * d.abs() <= seqlen,
                          dc * dc <= 4 * var)
    else:
        f32 = dict(dtype=torch.float32, device=hi.device)
        stddev = torch.where(
            var == 0,
            seqlen.to(torch.float32) * torch.tensor(zero_var_len_frac,
                                                    **f32),
            torch.sqrt(var.to(torch.float32)))
        okl = (d.to(torch.float32).abs()
               <= torch.tensor(len_sigma_window, **f32) * stddev)
    return f & valid & (func != hypo) & okl


def probe_wide_distance_reference(t_rows, start_row, lengths, L: int,
                                  W: int, drows, ov_drows, **kw):
    """Plain version of probe_wide_distance: the pack's plain version,
    then lookup_distance_reference."""
    hi, lo, valid = kmer_pack.pack_call_windows_rows16_reference(
        t_rows, start_row, lengths, L, W)
    return lookup_distance_reference(hi, lo, valid, lengths, drows,
                                     ov_drows, **kw)


def _check_distance_rows(drows, ov_drows, slots, ov_slots, bits, ov_bits,
                         has_overflow):
    if slots not in (2, 4):
        raise ValueError(f"drows: the kernel takes 2 or 4 slots per row, "
                         f"got {slots}")
    for name, t, S in (("drows", drows, slots),
                       ("ov_drows", ov_drows, ov_slots)):
        cl.check(t, name, torch.int32)
        if S < 1 or t.dim() != 2 or t.shape[1] != distance_row_words(S):
            raise ValueError(f"{name}: rows of {distance_row_words(S)} "
                             f"words expected for {S} slots, got shape "
                             f"{tuple(t.shape)}")
    if drows.shape[0] != 1 << bits or (
            has_overflow and ov_drows.shape[0] != 1 << ov_bits):
        raise ValueError("distance row counts do not match bits/ov_bits")
    hashing.check_bits(bits)
    if has_overflow:
        hashing.check_bits(ov_bits)
    # rows are read as 16-byte words
    cl.check_aligned(16, drows=drows, ov_drows=ov_drows)


def probe_wide_distance(t_rows, start_row, lengths, L: int, W: int, drows,
                        ov_drows, *, slots: int, ov_slots: int, salt: int,
                        bits: int, ov_salt: int, ov_bits: int,
                        has_overflow: bool, hypo: int,
                        len_sigma_window: float, zero_var_len_frac: float):
    """The found mask of matrix distance over the first W windows of each
    sequence of transfer rows.

    t_rows, start_row, lengths, L, W: as pack_call_windows_rows16 takes
    them (lengths are also the lengths the filter reads); drows,
    ov_drows: the main store's and the leaf's int32 distance rows
    (WideKmerTable.distance_rows_to_device) of slots and ov_slots slots.
    A window counts when its key is in the table, it is valid, its
    function is not ``hypo`` and the row's length lies within
    len_sigma_window standard deviations of the key's mean length
    (stddev = sqrt(var), or zero_var_len_frac * length when var == 0).
    At the reference's defaults (2.0, 0.1) the filter takes its exact
    integer form, else float32 arithmetic; kernel and plain version agree
    bit for bit in both.  -> (B, W) bool."""
    kmer_pack.check_widths(L, W)
    geometry = dict(slots=slots, ov_slots=ov_slots, salt=salt, bits=bits,
                    ov_salt=ov_salt, ov_bits=ov_bits,
                    has_overflow=has_overflow, hypo=hypo,
                    len_sigma_window=len_sigma_window,
                    zero_var_len_frac=zero_var_len_frac)
    if not cl.on_cuda(t_rows, start_row, lengths, drows, ov_drows):
        return probe_wide_distance_reference(
            t_rows, start_row, lengths, L, W, drows, ov_drows, **geometry)
    B, R = kmer_pack.check_rows(t_rows, start_row, lengths)
    _check_distance_rows(drows, ov_drows, slots, ov_slots, bits, ov_bits,
                         has_overflow)
    mask = torch.empty((B, W), dtype=torch.bool, device=t_rows.device)
    cl.launch("probe_wide_distance",
              [t_rows.data_ptr(), R, start_row.data_ptr(),
               lengths.data_ptr(), B, L, W, drows.data_ptr(), slots,
               salt & _M32, bits, ov_drows.data_ptr(), ov_slots,
               ov_salt & _M32, ov_bits, int(has_overflow), hypo,
               int(_exact_length_form(len_sigma_window, zero_var_len_frac)),
               float(np.float32(len_sigma_window)),
               float(np.float32(zero_var_len_frac)), mask.data_ptr()],
              t_rows.device)
    probe_wide_distance.launches += 1
    return mask


probe_wide_distance.launches = 0
