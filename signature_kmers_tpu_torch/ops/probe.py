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

The other layouts' probes take (hi, lo, valid) words too, with an aux
variant each: probe_bucket (the cuckoo table, rows padded to whole
32-byte sectors; csrc/probe_bucket.cu) and probe_cmph (a reference CMPH
store with its aliasing, one word or record per BDZ vertex;
csrc/probe_cmph.cu).  table_probe picks a table's probe; distance_filter
is the matrix-distance filter that runs as torch operations after an
aux probe on those layouts.  probe_table walks a mesh shard of the
linear-probing table (kernel L2, csrc/probe_table.cu) on linear_rows'
8-byte key and 16-byte value rows.
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
    return f & valid & distance_filter(fm, var, lengths, hypo=hypo,
                                       len_sigma_window=len_sigma_window,
                                       zero_var_len_frac=zero_var_len_frac)


def distance_filter(fm, var, lengths, *, hypo: int, len_sigma_window: float,
                    zero_var_len_frac: float):
    """The matrix-distance filters of (B, W) hits (the JAX package's
    models/matrix_distance.py, _gather's f): the function (fm >> 16) is
    not ``hypo``, and the sequence length lies within len_sigma_window
    standard deviations of the key's mean length (fm's low half), stddev
    = sqrt(var16), or zero_var_len_frac * length when var16 == 0.  At the
    reference's defaults (2.0, 0.1) the exact integer form, else float32
    arithmetic.  fm, var: int32 or int64 words (var's low 16 bits are
    read); lengths: (B,).  -> (B, W) bool."""
    func = (fm >> 16) & 0xFFFF
    mean = (fm & 0xFFFF).to(torch.int32)
    var = (var & 0xFFFF).to(torch.int32)
    seqlen = lengths.to(torch.int32)[:, None]
    d = seqlen - mean
    if _exact_length_form(len_sigma_window, zero_var_len_frac):
        # |d| <= 2*sqrt(var) <=> d^2 <= 4*var (|d| past 1024 fails anyway:
        # 4*var <= 262140); var == 0: |d| <= 0.2*seqlen <=> 5|d| <= seqlen
        dc = torch.clamp(d.abs(), max=1024)
        okl = torch.where(var == 0, 5 * d.abs() <= seqlen,
                          dc * dc <= 4 * var)
    else:
        f32 = dict(dtype=torch.float32, device=fm.device)
        stddev = torch.where(
            var == 0,
            seqlen.to(torch.float32) * torch.tensor(zero_var_len_frac,
                                                    **f32),
            torch.sqrt(var.to(torch.float32)))
        okl = (d.to(torch.float32).abs()
               <= torch.tensor(len_sigma_window, **f32) * stddev)
    return (func != hypo) & okl


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


# -- the cuckoo table: two-choice bucket probe --------------------------------


def lookup_bucket_reference(hi, lo, valid, packed, aux=None, *, salt: int):
    """Plain two-choice bucket lookup (the JAX package's ops/probe.py:
    probe_bucket, int64 arithmetic, any device) on the device layout
    (BucketKmerTable.to_device) -> (found, fm[, r0, r1, r2]) as int64,
    found masked by valid and every word 0 where nothing was found.
    packed: (n_buckets, 4*slots) int32 rows [khi*s, klo*s, fm*s, 0*s];
    aux: (n_buckets, 4*slots) slot-major [v0, v1, v2, 0] per slot."""
    s = packed.shape[1] // 4
    q_hi = hi.to(torch.int64) & _M32
    q_lo = lo.to(torch.int64) & _M32
    b1, b2 = hashing.bucket_hashes_t(hi, lo, salt, packed.shape[0])

    def match(b):
        row = packed[b].to(torch.int64) & _M32  # (..., 4*slots)
        m = (row[..., :s] == q_hi[..., None]) & (row[..., s:2 * s]
                                                 == q_lo[..., None])
        # at most one slot matches (keys are unique): the masked sum
        # selects it
        return m.any(dim=-1), (row[..., 2 * s:3 * s] * m).sum(dim=-1), m

    f1, fm1, m1 = match(b1)
    f2, fm2, m2 = match(b2)
    found = (f1 | f2) & valid
    fm = torch.where(found, torch.where(f1, fm1, fm2), 0)
    if aux is None:
        return found, fm
    bwin = torch.where(f1, b1, b2)
    mwin = torch.where(f1[..., None], m1, m2) & found[..., None]
    arow = aux[bwin].to(torch.int64).view(*bwin.shape, s, 4) & _M32
    return (found, fm) + tuple((arow[..., k] * mwin).sum(dim=-1)
                               for k in range(3))


def probe_bucket_reference(hi, lo, valid, packed, *, salt: int,
                           ignore_function: int = -1):
    """Plain version of probe_bucket."""
    found, fm = lookup_bucket_reference(hi, lo, valid, packed, salt=salt)
    found = found & (((fm >> 16) & 0xFFFF) != ignore_function)
    return found, hashing.to_i32(fm)


def probe_bucket_aux_reference(hi, lo, valid, packed, aux, *, salt: int):
    """Plain version of probe_bucket_aux."""
    found, *words = lookup_bucket_reference(hi, lo, valid, packed, aux,
                                            salt=salt)
    return (found,) + tuple(hashing.to_i32(w) for w in words)


def _check_windows(hi, lo, valid):
    shape = tuple(hi.shape)
    cl.check(hi, "hi", torch.int32)
    cl.check(lo, "lo", torch.int32, shape)
    cl.check(valid, "valid", torch.bool, shape)
    return shape


def _check_bucket(packed, aux):
    """The device layout's geometry (both routes check it)."""
    tables = dict(packed=packed) if aux is None else dict(packed=packed,
                                                          aux=aux)
    for name, t in tables.items():
        cl.check(t, name, torch.int32)
    nb, words = packed.shape if packed.dim() == 2 else (0, 0)
    if words not in (8, 16) or nb & (nb - 1) or nb == 0:
        raise ValueError(f"packed: a power-of-two count of rows of 4*slots "
                         f"words (2 or 4 slots, each row padded to whole "
                         f"32-byte sectors: BucketKmerTable.to_device) "
                         f"expected; got shape {tuple(packed.shape)}")
    if aux is not None and aux.shape != packed.shape:
        raise ValueError("aux rows must have the probe rows' shape "
                         "(BucketKmerTable.aux_to_device)")
    return tables


def _outputs(shape, dev, n_words: int):
    """found (bool) and n_words int32 outputs of a window probe."""
    return (torch.empty(shape, dtype=torch.bool, device=dev),
            *(torch.empty(shape, dtype=torch.int32, device=dev)
              for _ in range(n_words)))


def _ptrs(outs, aux: bool):
    """The output pointers as the C entry points take them: found, fm,
    then r0..r2 or three NULLs."""
    return [o.data_ptr() for o in outs] + ([] if aux else [None] * 3)


def _launch_bucket(hi, lo, valid, tables, salt, ignore_function):
    """tables: _check_bucket's."""
    shape = _check_windows(hi, lo, valid)
    # the kernel reads the windows four at a time (16-byte loads), and a
    # row is whole sectors only from a 32-byte boundary
    cl.check_aligned(16, hi=hi, lo=lo, valid=valid)
    cl.check_aligned(32, **tables)
    packed, aux = tables["packed"], tables.get("aux")
    outs = _outputs(shape, hi.device, 1 if aux is None else 4)
    cl.launch("probe_bucket",
              [hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), hi.numel(),
               packed.data_ptr(), packed.shape[1] // 4, packed.shape[0],
               salt & _M32, None if aux is None else aux.data_ptr(),
               ignore_function, *_ptrs(outs, aux is not None)],
              hi.device)
    return outs


def probe_bucket(hi, lo, valid, packed, *, salt: int,
                 ignore_function: int = -1):
    """Probe a cuckoo table (table/bucket_table.py) for windows.

    hi, lo: int32 packed window words; valid: bool call mask; packed: the
    table's int32 probe rows, padded to whole sectors
    (BucketKmerTable.to_device); salt: the table's.  -> (found bool, fm
    int32): found = key in the table & valid & fm's function !=
    ignore_function (-1: none); fm is the matched slot's word wherever
    the key was found under valid, else 0."""
    tables = _check_bucket(packed, None)
    if not cl.on_cuda(hi, lo, valid, packed):
        return probe_bucket_reference(hi, lo, valid, packed, salt=salt,
                                      ignore_function=ignore_function)
    out = _launch_bucket(hi, lo, valid, tables, salt, ignore_function)
    probe_bucket.launches += 1
    return out


probe_bucket.launches = 0


def probe_bucket_aux(hi, lo, valid, packed, aux, *, salt: int):
    """probe_bucket with the matched slot's three value words from the
    slot-major aux rows (BucketKmerTable.to_device(with_aux=True)).  ->
    (found bool, fm, r0, r1, r2 int32), found masked by valid only; every
    word 0 where nothing was found."""
    tables = _check_bucket(packed, aux)
    if not cl.on_cuda(hi, lo, valid, packed, aux):
        return probe_bucket_aux_reference(hi, lo, valid, packed, aux,
                                          salt=salt)
    out = _launch_bucket(hi, lo, valid, tables, salt, -1)
    probe_bucket_aux.launches += 1
    return out


probe_bucket_aux.launches = 0


# -- a reference CMPH store: the BDZ search, aliasing -------------------------

_CODE_TO_BYTE = None


def _code_to_byte(device) -> torch.Tensor:
    global _CODE_TO_BYTE
    if _CODE_TO_BYTE is None:
        from ..core.alphabet import CODE_TO_BYTE

        _CODE_TO_BYTE = torch.from_numpy(CODE_TO_BYTE.astype(np.int64))
    return _CODE_TO_BYTE.to(device)


def cmph_vertices(hi, lo, g, *, seed: int, r: int) -> torch.Tensor:
    """Each window's selected BDZ vertex, int64 (the JAX package's
    table/cmph_table.py: CmphKmerTable.probe up to the rank read): the
    key's 8 bytes as the reference stores them (CODE_TO_BYTE), one
    Jenkins mix gives three vertices, and the 2-bit g values select
    one."""
    lut = _code_to_byte(hi.device)

    def word_le(w):
        w = w.to(torch.int64) & _M32
        return (lut[(w >> 18) & 63] | (lut[(w >> 12) & 63] << 8)
                | (lut[(w >> 6) & 63] << 16) | (lut[w & 63] << 24))

    a = (word_le(hi) + hashing._GOLDEN) & _M32
    b = (word_le(lo) + hashing._GOLDEN) & _M32
    c = torch.full_like(a, (seed + 8) & _M32)
    h = hashing.jenkins_mix_t(a, b, c)
    hl = [(x % r) + k * r for k, x in enumerate(h)]
    gv = [(g[v >> 2].to(torch.int64) >> ((v & 3) << 1)) & 3 for v in hl]
    sel = (gv[0] + gv[1] + gv[2]) % 3
    return torch.where(sel == 0, hl[0], torch.where(sel == 1, hl[1], hl[2]))


def lookup_cmph_reference(hi, lo, valid, g, vfm, vrec=None, *, seed: int,
                          r: int, n_live: int):
    """Plain BDZ search with the reference's aliasing, on the device
    layout (CmphKmerTable.to_device; int64 arithmetic, any device) ->
    (found, fm[, r0, r1, r2]) as int64: found = vertex < n_live & valid
    (rank < m, the reference's only test), fm = vfm[vertex] or, with
    vrec, the vertex's record (v0, v1, v2) and fm from v0 and v1; every
    word 0 where not found."""
    vertex = cmph_vertices(hi, lo, g, seed=seed, r=r)
    found = (vertex < n_live) & valid
    vertex = torch.where(found, vertex, 0)
    if vrec is None:
        return found, torch.where(found, vfm[vertex].to(torch.int64) & _M32,
                                  0)
    rec = vrec[vertex].to(torch.int64) & _M32
    words = [torch.where(found, rec[..., k], 0) for k in range(3)]
    fm = (words[0] & 0xFFFF0000) | (words[1] & 0xFFFF)
    return (found, fm, *words)


def probe_cmph_reference(hi, lo, valid, g, vfm, *, seed: int, r: int,
                         n_live: int, ignore_function: int = -1):
    """Plain version of probe_cmph."""
    found, fm = lookup_cmph_reference(hi, lo, valid, g, vfm, seed=seed, r=r,
                                      n_live=n_live)
    found = found & (((fm >> 16) & 0xFFFF) != ignore_function)
    return found, hashing.to_i32(fm)


def probe_cmph_aux_reference(hi, lo, valid, g, vfm, vrec, *, seed: int,
                             r: int, n_live: int):
    """Plain version of probe_cmph_aux."""
    found, *words = lookup_cmph_reference(hi, lo, valid, g, vfm, vrec,
                                          seed=seed, r=r, n_live=n_live)
    return (found,) + tuple(hashing.to_i32(w) for w in words)


def _check_cmph(g, vfm, vrec, r, n_live):
    """The device layout's geometry (both routes check it)."""
    if r <= 0 or 3 * r >= 1 << 31:
        raise ValueError(f"bad BDZ geometry: r {r}")
    if not 0 <= n_live <= 3 * r:
        raise ValueError(f"n_live {n_live} out of range [0, 3r = {3 * r}]")
    cl.check(g, "g", torch.uint8, (-(-3 * r // 4),))
    cl.check(vfm, "vfm", torch.int32, (3 * r,))
    if vrec is not None:
        cl.check(vrec, "vrec", torch.int32, (3 * r, 4))


def _launch_cmph(hi, lo, valid, g, vfm, vrec, seed, r, n_live,
                 ignore_function):
    shape = _check_windows(hi, lo, valid)
    if vrec is not None:  # one 16-byte load per record
        cl.check_aligned(16, vrec=vrec)
    outs = _outputs(shape, hi.device, 1 if vrec is None else 4)
    cl.launch("probe_cmph",
              [hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), hi.numel(),
               g.data_ptr(), vfm.data_ptr(),
               None if vrec is None else vrec.data_ptr(), seed & _M32, r,
               n_live, ignore_function, *_ptrs(outs, vrec is not None)],
              hi.device)
    return outs


def probe_cmph(hi, lo, valid, g, vfm, *, seed: int, r: int, n_live: int,
               ignore_function: int = -1):
    """Probe a reference CMPH store (table/cmph_table.py) for windows,
    with the reference's aliasing: a key outside the set reads some real
    record (cmph_kmer.h:138-147).

    hi, lo, valid: as probe_bucket takes them; g (uint8 bytes) and vfm
    (int32 per vertex): CmphKmerTable.to_device; seed, r: the store's BDZ
    geometry, n_live: the vertices with a record (CmphKmerTable.n_live).
    -> (found bool, fm int32): found = vertex < n_live & valid & fm's
    function != ignore_function; fm = vfm[vertex] (the indexed record's
    (v0 & 0xFFFF0000) | (v1 & 0xFFFF)) where vertex < n_live under valid,
    else 0."""
    _check_cmph(g, vfm, None, r, n_live)
    if not cl.on_cuda(hi, lo, valid, g, vfm):
        return probe_cmph_reference(hi, lo, valid, g, vfm, seed=seed, r=r,
                                    n_live=n_live,
                                    ignore_function=ignore_function)
    out = _launch_cmph(hi, lo, valid, g, vfm, None, seed, r, n_live,
                       ignore_function)
    probe_cmph.launches += 1
    return out


probe_cmph.launches = 0


def probe_cmph_aux(hi, lo, valid, g, vfm, vrec, *, seed: int, r: int,
                   n_live: int):
    """probe_cmph with the indexed record's three value words, read from
    the per-vertex records vrec (CmphKmerTable.aux_to_device; vfm is
    taken as the caller holds it and not read).  -> (found bool, fm, r0,
    r1, r2 int32), found masked by valid only; every word 0 where not
    found."""
    _check_cmph(g, vfm, vrec, r, n_live)
    if not cl.on_cuda(hi, lo, valid, g, vfm, vrec):
        return probe_cmph_aux_reference(hi, lo, valid, g, vfm, vrec,
                                        seed=seed, r=r, n_live=n_live)
    out = _launch_cmph(hi, lo, valid, g, vfm, vrec, seed, r, n_live, -1)
    probe_cmph_aux.launches += 1
    return out


probe_cmph_aux.launches = 0


# -- the linear-probing table: one ShardedKmerTable shard ---------------------

_EMPTY = 0xFFFF_FFFF  # an empty slot's key words


def linear_rows(key_hi, key_lo, v0, v1, v2):
    """The device layout of a linear-probing table from its five int32
    word arrays (S slots each): keys (S, 2) = (key_hi, key_lo) per slot,
    8 bytes, and vals (S, 4) = (v0, v1, v2, 0) per slot, 16 bytes inside
    one sector, both int32 on the words' device (torch ops).  The kernel
    reads a slot's two key words with one load and a hit's value words
    with one more."""
    words = dict(key_hi=key_hi, key_lo=key_lo, v0=v0, v1=v1, v2=v2)
    if key_hi.dim() != 1:
        raise ValueError(f"key_hi: a 1-D word array expected, got shape "
                         f"{tuple(key_hi.shape)}")
    for name, w in words.items():
        cl.check(w, name, torch.int32, key_hi.shape)
    return (torch.stack((key_hi, key_lo), dim=1),
            torch.stack((v0, v1, v2, torch.zeros_like(v0)), dim=1))


def _check_rows(keys, vals):
    """Raise TypeError or ValueError unless keys and vals are
    linear_rows' int32 rows of S slots, S a power of two that fits 32
    bits."""
    S = keys.shape[0] if keys.dim() == 2 else 0
    cl.check(keys, "keys", torch.int32, (S, 2))
    cl.check(vals, "vals", torch.int32, (S, 4))
    if S == 0 or S & (S - 1) or S > 1 << 32:
        raise ValueError(f"keys: a power-of-two slot count expected, got "
                         f"shape {tuple(keys.shape)}")


def probe_table_reference(keys, vals, qhi, qlo, max_probes: int):
    """Plain version of probe_table: the JAX package's lock-step rounds
    (ops/probe.py: probe_table), one slot per query a round until each has
    hit its key or an empty slot, at most max(max_probes, 1) rounds, then
    the hits' value rows (int64 arithmetic, any device)."""
    mask = keys.shape[0] - 1
    qh = qhi.to(torch.int64) & _M32
    ql = qlo.to(torch.int64) & _M32
    cur = hashing.hash_kmer_t(qh, ql) & mask
    done = torch.zeros(qh.shape, dtype=torch.bool, device=qh.device)
    found = done.clone()
    slot = torch.zeros_like(cur)
    for _ in range(max(max_probes, 1)):
        k = keys[cur].to(torch.int64) & _M32
        hit = (k[..., 0] == qh) & (k[..., 1] == ql) & ~done
        empty = (k[..., 0] == _EMPTY) & ~done
        slot = torch.where(hit, cur, slot)
        found |= hit
        done |= hit | empty
        if bool(done.all()):
            break
        cur = (cur + 1) & mask
    v = torch.where(found[..., None], vals[slot][..., :3], 0)
    return (found, *v.movedim(-1, 0).contiguous())


def probe_table(keys, vals, qhi, qlo, max_probes: int):
    """Probe a linear-probing table for packed query keys.

    keys, vals: the table's rows (linear_rows), S slots with S a power of
    two, an empty slot's key words 0xFFFFFFFF; qhi, qlo: int32 query words
    (bit containers of uint32) of any equal shape; max_probes: the table's
    longest chain.  -> (found bool, r0, r1, r2 int32): r* the matched
    slot's v0..v2 where found, else 0."""
    _check_rows(keys, vals)
    cl.check(qhi, "qhi", torch.int32)
    cl.check(qlo, "qlo", torch.int32, qhi.shape)
    if not cl.on_cuda(qhi, qlo, keys, vals):
        return probe_table_reference(keys, vals, qhi, qlo, max_probes)
    # a key row is one 8-byte load, a value row one 16-byte load
    cl.check_aligned(8, keys=keys)
    cl.check_aligned(16, vals=vals)
    outs = _outputs(tuple(qhi.shape), qhi.device, 3)
    cl.launch("probe_table",
              [keys.data_ptr(), vals.data_ptr(), keys.shape[0],
               qhi.data_ptr(), qlo.data_ptr(), qhi.numel(), max_probes,
               *(o.data_ptr() for o in outs)],
              qhi.device)
    probe_table.launches += 1
    return outs


probe_table.launches = 0


# -- one probe per layout -----------------------------------------------------


def table_probe(table, with_aux: bool = False):
    """The device probe of ``table``'s layout over (hi, lo, valid) windows
    -> (fn, geometry): fn(hi, lo, valid, *tables, **geometry) with tables
    = the layout's to_device(device, with_aux) words, and
    ``ignore_function`` accepted without aux.  The wide layout's aux probe
    reads transfer rows (probe_wide_aux), so it is not offered here.
    Raises TypeError for a table type with no device probe."""
    from ..table import BucketKmerTable, CmphKmerTable, WideKmerTable

    if isinstance(table, WideKmerTable):
        if with_aux:
            raise ValueError("the wide layout's aux probe is probe_wide_aux "
                             "(transfer rows in)")
        return probe_wide, dict(salt=table.salt, bits=table.bits,
                                ov_salt=table.ov_salt, ov_bits=table.ov_bits,
                                has_overflow=table.ov_items > 0)
    if isinstance(table, BucketKmerTable):
        return (probe_bucket_aux if with_aux else probe_bucket,
                dict(salt=table.salt))
    if isinstance(table, CmphKmerTable):
        mph = table.mph
        return (probe_cmph_aux if with_aux else probe_cmph,
                dict(seed=mph.seed, r=mph.r, n_live=table.n_live))
    raise TypeError(f"no device probe for table type "
                    f"{type(table).__name__}: the port probes "
                    f"WideKmerTable, BucketKmerTable and CmphKmerTable")
