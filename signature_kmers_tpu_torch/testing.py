"""Inputs on the edges of the kernels' tilings, made from a seed with numpy.

One generator for every place that holds a kernel or a plain version to
another: ``chip_smoke.py`` phase 2 and ``tests/test_torch_kernels_cuda.py``
(kernel against plain version on the card) and the CPU tests (plain version
against the JAX package).  The pack kernel and the fused probes take 16
windows per thread from two transfer rows; the automaton kernel runs one
warp per row over steps of 32 windows; the call-path probe takes 4
windows per thread.  Also the exact host route of the distance mask
(distance_found_host), for checks.
Nothing on the main path imports this module.
"""

from __future__ import annotations

import numpy as np

MIN_HITS, MAX_GAP = 5, 200  # CallConfig's defaults, which the rows straddle


def _edge_rows(W: int):
    """(name, [(position, function, mean)], sequence length) per row."""
    every = range(W)
    same5 = [(p, 9, 290 + 3 * p) for p in range(5)]
    distinct5 = [(3 * i, 100 + i, 300) for i in range(5)]
    return [
        # one record of W members (> 255 from W = 256 on), function 0xFFFE
        ("all_hit", [(p, 0xFFFE, 250 + p * 37 % 101) for p in every], 305),
        # function 0, one constant mean: mad 0 -> the floor
        ("all_hit_fn0", [(p, 0, 300) for p in every], 300),
        ("ends_only", [(0, 5, 300), (W - 1, 5, 300)], 300),
        ("ends_blocks", [(p, 6, 300) for p in range(5)]
         + [(W - 1 - p, 6, 310) for p in range(5)], 300),
        # more than 32 members, one per third window
        ("members_40", [(3 * i, 7, 260 + i * 11 % 80) for i in range(40)],
         300),
        # the next hit exactly max_gap after the last: no flush
        ("gap_exact", same5 + [(4 + MAX_GAP + i, 9, 300) for i in range(5)],
         300),
        # one window further: the gap flushes a record
        ("gap_plus_one",
         same5 + [(5 + MAX_GAP + i, 9, 300) for i in range(5)], 300),
        ("zero_hits", [], 300),
        # five hits of five functions: a record with 1 member < min_hits
        ("below_min_hits", distinct5
         + [(p + 40 + MAX_GAP, f, m) for p, f, m in distinct5], 300),
        # eight same-function blocks: every block switch flushes a record
        ("rec_cap_overflow", [(b * 40 + j * 4, 33000 + b, 300)
                              for b in range(8) for j in range(8)], 330),
        ("length_guard", [(p, 7, 300) for p in range(0, 60, 6)], 70000),
        # constant means: mad 0 -> the floor (mad_floor 30.1 -> host)
        ("const_means", [(p, 40000, 300) for p in range(0, 60, 6)], 300),
        ("spread_means", [(p, 40001, 280 + p) for p in range(0, 60, 6)],
         300),
    ]


EDGE_ROW_NAMES = tuple(name for name, _, _ in _edge_rows(48))


def automaton_rows(W: int, n_random: int = 64, seed: int = 1):
    """Rows of automaton input at width W: the named edge rows (hits past
    W dropped), then n_random random rows over a few functions either side
    of 32768.  Returns (names, found (B, W) bool, fm (B, W) uint32,
    lengths (B,) int32); names[i] is row i's name ("random" for those).
    fm words of windows without a hit are random, as in production."""
    rng = np.random.default_rng(seed)
    rows = _edge_rows(W)
    for _ in range(n_random):
        density = rng.random() * 0.8
        pos = np.flatnonzero(rng.random(W) < density)
        funcs = 32766 + rng.integers(0, 1 + int(rng.integers(0, 5)),
                                     pos.shape[0])
        means = rng.integers(200, 400, pos.shape[0])
        rows.append(("random", list(zip(pos.tolist(), funcs.tolist(),
                                        means.tolist())),
                     int(rng.integers(100, 520))))
    B = len(rows)
    found = np.zeros((B, W), bool)
    fm = rng.integers(0, 1 << 32, (B, W), dtype=np.uint64).astype(np.uint32)
    for i, (_, hits, _) in enumerate(rows):
        for p, f, m in hits:
            if 0 <= p < W:
                found[i, p] = True
                fm[i, p] = (f << 16) | m
    lengths = np.array([ln for _, _, ln in rows], np.int32)
    return [name for name, _, _ in rows], found, fm, lengths


def transfer_rows(L: int, B: int, seed: int, max_len: int | None = None):
    """Query transfer rows (pack_u6_rows_host's format) at padded width L
    for B >= 50 sequences: edge sequences, then random ones over the 20
    amino acids with '*', 'X' and 'x' of lengths U[0, max_len] (default L).

    The edges: lengths 0-8, multiples of 16, L-9..L-7, L-1 and one longer
    than L; '*', 'X' and 'x' alone at the 1st, 8th, 9th, 16th, 17th, 24th
    and 25th code and at L-9, L-8 and L-1.  The all-INVALID row that
    pack_u6_rows_host appends is dropped, and the last sequence (length
    L) starts on the row before the last, so its groups run past R - 1
    into the clamp and read codes there.
    Returns (packed (R, 3) uint32, start_row (B,) int32, lengths (B,)
    int32)."""
    from .core import alphabet
    from .ops.kmer_pack import ALIGN, pack_u6_rows_host

    rng = np.random.default_rng(seed)
    aa = alphabet.encode_seq(alphabet.AA20)
    mixed = alphabet.encode_seq(alphabet.AA20 + "*Xx")

    def plain(n):
        return aa[rng.integers(0, aa.shape[0], n)]

    seqs = [plain(n) for n in (*range(9), 16, 32, 48, L - 16, L, L - 9,
                               L - 8, L - 7, L - 1, L + 40)]
    for code in alphabet.encode_seq("*Xx"):
        for pos in (0, 7, 8, 15, 16, 23, 24, L - 9, L - 8, L - 1):
            s = plain(L)
            s[pos] = code
            seqs.append(s)
    top = L if max_len is None else max_len
    for n in rng.integers(0, top + 1, B - len(seqs) - 1):
        seqs.append(mixed[rng.integers(0, mixed.shape[0], n)])
    seqs.append(plain(L))
    codes = np.concatenate(seqs)
    offsets = np.concatenate([[0], np.cumsum([s.shape[0] for s in seqs])])
    packed, start_row, lengths = pack_u6_rows_host(
        codes, offsets.astype(np.int32), B, L)
    R = int(start_row[-1]) + L // ALIGN
    start_row[-1] = R - 2
    return packed[:R], start_row, lengths


def key_transfer_rows(hi, lo, L: int, B: int, seed: int, over: int = 40):
    """Transfer rows at padded width L of B >= 8 sequences made of table
    keys (hi, lo): the windows at multiples of 8 are keys, the rest
    straddle two keys, and the keys' 6-bit groups take every code, '*',
    'X' and INVALID included.  Lengths: 0, 1, 8, 9, L - 1, L, L + over,
    then U[0, L + over] (past L where they are, unclamped: the pack reads
    no code past L, the distance filter reads the length).  The last
    sequence's groups run past the last row into the clamp, as in
    transfer_rows.  Returns (packed (R, 3) uint32, start_row (B,) int32,
    lengths (B,) int32)."""
    from .ops.kmer_pack import ALIGN, pack_u6_rows_host

    rng = np.random.default_rng(seed)
    pick = rng.integers(0, hi.shape[0], (B, L // 8))
    words = np.stack([hi[pick], lo[pick]], axis=-1)  # (B, L/8, 2)
    shifts = np.array([18, 12, 6, 0], np.uint32)
    codes = ((words[..., None] >> shifts) & 63).astype(np.uint8)
    codes = codes.reshape(B, L)
    lengths = np.concatenate([[0, 1, 8, 9, L - 1, L, L + over],
                              rng.integers(0, L + over + 1, B - 8),
                              [L]]).astype(np.int32)
    n = np.minimum(lengths, L)
    offsets = np.concatenate([[0], np.cumsum(n)]).astype(np.int64)
    flat = codes[np.arange(L)[None, :] < n[:, None]]
    packed, start_row, _ = pack_u6_rows_host(flat, offsets, B, L)
    R = int(start_row[-1]) + L // ALIGN
    start_row[-1] = R - 2
    return packed[:R], start_row, lengths


def probe_queries(hi, lo, shape, seed: int, hit_rate: float = 0.5,
                  valid_rate: float = 0.9):
    """(qhi, qlo, valid) uint32/uint32/bool query windows of the given
    shape: hit_rate of them table keys (hi, lo), the rest random."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, hi.shape[0], shape)
    hit = rng.random(shape) < hit_rate
    qhi = np.where(hit, hi[pick], rng.integers(0, 1 << 24, shape))
    qlo = np.where(hit, lo[pick], rng.integers(0, 1 << 24, shape))
    return (qhi.astype(np.uint32), qlo.astype(np.uint32),
            rng.random(shape) < valid_rate)


HYPO_FUNCTION = 4242  # the function value_entries gives every 7th key


def value_entries(n: int, seed: int):
    """(hi, lo, v0, v1, v2) uint32 of about n distinct random keys whose
    value words reach every branch of the distance filter: means
    U[60, 3000), var 0 for a third of the keys and U[1, 400) for a fifth
    of the rest, function HYPO_FUNCTION for every 7th key and any 16-bit
    value otherwise (many above 32767)."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << 48, n, dtype=np.uint64))
    m = keys.shape[0]
    hi = (keys >> np.uint64(24)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFF)).astype(np.uint32)
    fn = rng.integers(0, 65535, m).astype(np.uint32)
    fn[::7] = HYPO_FUNCTION
    v0 = (fn << 16) | rng.integers(0, 600, m).astype(np.uint32)
    mean = rng.integers(60, 3000, m).astype(np.uint32)
    v1 = (rng.integers(0, 1 << 16, m, dtype=np.uint32) << 16) | mean
    var = rng.integers(0, 1 << 16, m).astype(np.uint32)
    var[1::5] = rng.integers(1, 400, var[1::5].shape[0])
    var[::3] = 0
    v2 = (rng.integers(0, 1 << 16, m, dtype=np.uint32) << 16) | var
    return hi, lo, v0, v1, v2


def distance_lengths(B: int, seed: int):
    """(B,) int32 sequence lengths U[0, 4000): |length - mean| runs past
    1024, where the exact filter form caps it."""
    return np.random.default_rng(seed).integers(0, 4000, B).astype(np.int32)


def distance_found_host(table, hypo: int, config, codes: np.ndarray,
                        lengths: np.ndarray) -> np.ndarray:
    """The exact host route of MatrixDistance._gather: host table probe of
    (B, L) padded codes and the reference's float64 filters (config a
    DistanceConfig) -> (B, L) found mask."""
    from .core import alphabet
    from .golden.call import valid_call_windows

    B, L = codes.shape
    hi = np.zeros((B, L), dtype=np.uint32)
    lo = np.zeros((B, L), dtype=np.uint32)
    valid = np.zeros((B, L), dtype=bool)
    for i in range(B):
        nlen = int(lengths[i])
        row = codes[i, :nlen]
        h, l = alphabet.pack_codes_np(row)
        hi[i, :max(nlen - 7, 0)] = h
        lo[i, :max(nlen - 7, 0)] = l
        v = valid_call_windows(row)
        valid[i, :v.shape[0]] = v
    found, r0, r1, r2 = table.lookup_np(hi, lo)
    found &= valid & ((r0 >> 16) != hypo)
    mean = (r1 & 0xFFFF).astype(np.int64)
    var = r2 & 0xFFFF
    seqlen = lengths.astype(np.float64)[:, None]
    stddev = np.where(var == 0, seqlen * config.zero_var_len_frac,
                      np.sqrt(var.astype(np.float64)))
    w = config.len_sigma_window
    okl = (seqlen >= mean - stddev * w) & (seqlen <= mean + stddev * w)
    return found & okl
