"""Inputs on the edges of the kernels' tilings, made from a seed with numpy.

One generator for every place that holds a kernel or a plain version to
another: ``chip_smoke.py`` phase 2 and ``tests/test_torch_kernels_cuda.py``
(kernel against plain version on the card) and the CPU tests (plain version
against the JAX package).  The pack kernel and the fused probes take 16
windows per thread from two transfer rows; the automaton kernel runs one
warp per row over steps of 32 windows; the call-path probe takes 4
windows per thread.  The build's kernels take a warp per sequence
(extraction, which holds a sequence's codes in chunks) and tiles of
sorted entries with a thread per small k-mer group and a warp per large
one (selection): build_rows, select_windows and select_tile_edges; the
build's corpus at the reference's scale on disk: build_corpus.  The
linear probe walks a query's chain over 8-byte key rows, four to a
32-byte sector: linear_cases (chains that wrap past the last slot or
cross a sector, walks cut at max_probes, a table of one sector).  Also
the exact host route of the distance mask (distance_found_host), for
checks.

Run as a module it is the rank entry point of multi-process runs
(rank_main: the CLI, or the mesh programs on a process-spanning mesh), used by
tests/test_torch_multiprocess.py and chip_smoke.py's phase 3j.
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


def bucket_cases(n: int, seed: int, slots: int = 2):
    """A cuckoo table over value_entries(n, seed) and query windows on the
    edges of the two-choice probe (kernel 8): every stored key (keys in
    their second bucket, keys at every slot position), as many random
    aliens (most of them meet rows with empty slots), and about a tenth
    of the windows invalid, in random order.  -> (table, (qhi, qlo,
    valid) uint32/uint32/bool, {"second_bucket": keys placed in their
    second bucket, "slot_k": keys at slot k})."""
    from .core.config import TableConfig
    from .table.bucket_table import BucketKmerTable, bucket_hashes

    hi, lo, v0, v1, v2 = value_entries(n, seed)
    table = BucketKmerTable.build(hi, lo, v0, v1, v2,
                                  TableConfig(layout="cuckoo", slots=slots))
    S = table.slots
    b1, _ = bucket_hashes(hi, lo, table.salt, table.n_buckets)
    row = table.packed[b1]
    in_first = ((row[:, :S] == hi[:, None])
                & (row[:, S:2 * S] == lo[:, None])).any(axis=1)
    stats = {"second_bucket": int((~in_first).sum())}
    for k in range(S):
        stats[f"slot_{k}"] = int((table.packed[:, k] != 0xFFFFFFFF).sum())
    rng = np.random.default_rng(seed + 1)
    m = hi.shape[0]
    qhi = np.concatenate([hi, rng.integers(0, 1 << 24, m).astype(np.uint32)])
    qlo = np.concatenate([lo, rng.integers(0, 1 << 24, m).astype(np.uint32)])
    order = rng.permutation(2 * m)
    valid = rng.random(2 * m) < 0.9
    return table, (qhi[order], qlo[order], valid), stats


def _cmph_table(mph, rng):
    from .interop.cmph import STORED_KMER_DTYPE
    from .table.cmph_table import CmphKmerTable

    values = np.zeros(mph.m, dtype=STORED_KMER_DTYPE)
    for name in STORED_KMER_DTYPE.names:
        values[name] = rng.integers(0, 1 << 16, mph.m)
    return CmphKmerTable(mph, values)


def cmph_cases(n: int, seed: int):
    """Two reference CMPH stores with query windows for the BDZ probe
    (kernel 9): [(table, (qhi, qlo, valid) uint32/uint32/bool), ...].

    - a BDZ store (interop/cmph.build_bdz) over n random keys of codes
      0-52 (upper- and lower-case letters and '*': distinct bytes),
      queried with every key and as many aliens of any of the 64 codes
      (lower-case letters and the codes that all map to '?'), which alias
      onto real records;
    - a store made by hand, r = 5 and a few assigned vertices, the last
      ones unassigned, so that a key whose selected vertex lies above the
      last assigned one gets idx == m (the one miss), queried with random
      keys.
    About a tenth of the windows are invalid."""
    from .interop import cmph

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 53, (n, 8)).astype(np.uint32)
    w = codes << np.array([18, 12, 6, 0] * 2, dtype=np.uint32)
    keys = np.unique(((w[:, :4].sum(axis=1).astype(np.uint64) << 24)
                      | w[:, 4:].sum(axis=1)))
    hi = (keys >> np.uint64(24)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFF)).astype(np.uint32)
    real = _cmph_table(cmph.build_bdz(cmph.keys_from_packed(hi, lo),
                                      seed0=seed), rng)
    m = hi.shape[0]
    qhi = np.concatenate([hi, rng.integers(0, 1 << 24, m).astype(np.uint32)])
    qlo = np.concatenate([lo, rng.integers(0, 1 << 24, m).astype(np.uint32)])
    order = rng.permutation(2 * m)
    cases = [(real, (qhi[order], qlo[order], rng.random(2 * m) < 0.9))]

    r, b = 5, 7
    gv = np.array([0, 1, 3, 2, 3, 1, 3, 0, 3, 3, 2, 3, 3, 3, 3])
    assigned = int((gv != cmph.UNASSIGNED).sum())
    mph = cmph.BdzMph(int(rng.integers(0, 1 << 32)), 3 * r, assigned, r,
                      cmph._pack_g(gv), 1 << b, b,
                      np.zeros(1, dtype=np.uint32))
    q = 4096
    cases.append((_cmph_table(mph, rng),
                  (rng.integers(0, 1 << 24, q).astype(np.uint32),
                   rng.integers(0, 1 << 24, q).astype(np.uint32),
                   rng.random(q) < 0.9)))
    return cases


def linear_cases(seed: int):
    """(label, table, qhi, qlo, max_probes) cases of the linear probe
    (ops/probe.probe_table) on KmerTable.build layouts: chains at load 0.6
    in 1024 slots with members, aliens and a query of two 0xFFFFFFFF words
    (it "hits" an empty slot); the same walks cut at 1 slot and at 0
    (taken as 1); keys crowded onto the last slots, whose chains wrap past
    slot 1023 to slot 0; a table with no key; keys and aliens whose home
    is the last slot of a 32-byte key sector (slot 4k + 3), so that their
    walks cross into the next sector, and from slot 1023 to slot 0; and a
    table of four slots, one 32-byte key sector, holding three keys of
    home slot 3, whose walks wrap inside that sector (3, 0, 1) and are cut
    at max_probes."""
    from .core.config import TableConfig
    from .ops import hashing
    from .table.kmer_table import KmerTable

    rng = np.random.default_rng(seed)

    def keys(n):
        k = np.unique(rng.integers(0, 1 << 48, 2 * n, dtype=np.int64))
        k = rng.permutation(k)[:n]
        return ((k >> 24).astype(np.uint32),
                (k & 0xFFFFFF).astype(np.uint32))

    def values(n):
        return [rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
            np.uint32) for _ in range(3)]

    def queries(hi, lo, ah, al):
        qh = np.concatenate([hi, ah, [0xFFFFFFFF]]).astype(np.uint32)
        ql = np.concatenate([lo, al, [0xFFFFFFFF]]).astype(np.uint32)
        order = rng.permutation(qh.shape[0])
        return qh[order], ql[order]

    hi, lo = keys(600)
    t = KmerTable.build(hi, lo, *values(600))
    qh, ql = queries(hi, lo, *keys(501))
    # keys whose home slot is one of the last four: their chains wrap
    ch, cl = keys(200_000)
    home = hashing.hash_kmer(ch, cl) & np.uint32(1023)
    last = home >= 1020
    wh, wl = ch[last][:24], cl[last][:24]
    w = KmerTable.build(wh, wl, *values(wh.shape[0]))
    wqh, wql = queries(wh, wl, *keys(40))
    empty = KmerTable.build(hi[:0], lo[:0], *values(0))
    # homes at the last slot of a sector: 300 keys on 256 such slots
    edge = (home & np.uint32(3)) == 3
    eh, el = ch[edge], cl[edge]
    e = KmerTable.build(eh[:300], el[:300], *values(300))
    eqh, eql = queries(eh[:300], el[:300], eh[300:400], el[300:400])
    # three keys in four slots, all at home slot 3: they fill 3, 0, 1
    th, tl = eh[-3:], el[-3:]
    tiny = KmerTable.build(th, tl, *values(3),
                           TableConfig(min_size=4, load_factor=0.8))
    tqh, tql = queries(th, tl, *keys(40))
    return [("chains", t, qh, ql, t.max_probes),
            ("cut at 1 slot", t, qh, ql, 1),
            ("max_probes 0", t, qh, ql, 0),
            ("wrapping chains", w, wqh, wql, w.max_probes),
            ("no key", empty, qh, ql, empty.max_probes),
            ("sector crossings", e, eqh, eql, e.max_probes),
            ("four slots", tiny, tqh, tql, tiny.max_probes)]


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


def _build_codes():
    """(upper-case amino-acid codes, lower-case ones, codes >= 32)."""
    from .core import alphabet

    upper = alphabet.encode_seq(alphabet.AA20)
    lower = alphabet.encode_seq(alphabet.AA20.lower())
    return upper, lower, lower[lower >= 32]


def build_rows(B: int, seed: int, max_len: int = 300,
               long_lens: tuple = (), odd_rate: float = 0.02):
    """The build's transfer rows (pack_u8_rows) of B >= 40 sequences:
    edge sequences, then one of each length in long_lens, then random ones
    of lengths U[8, max_len].

    Residues are amino acids of either case (lower-case codes 26-51; a
    window starting at a code >= 32 has bit 63 set in its packed key),
    with '*', 'X', 'x' and 'B' mid-sequence (each residue at odd_rate).
    The edges: lengths 0, 7, 8, 9, 15, 16, 17, 31, 32, 33; a lower-case
    first code >= 32; '*', 'X' and 'x' alone at the 1st, 8th, 9th and last
    code.  A length-0 sequence shares its start with the next one.
    Returns (codes (R*16,) uint8, starts, fidx, plen, sid (B,) int32)."""
    from .core import alphabet
    from .ops.kmer_pack import ALIGN, pack_u8_rows

    rng = np.random.default_rng(seed)
    upper, lower, high = _build_codes()
    both = np.concatenate([upper, lower])
    odd = alphabet.encode_seq("*XxB")

    def residues(n):
        s = both[rng.integers(0, both.shape[0], n)]
        hit = rng.random(n) < odd_rate
        s[hit] = odd[rng.integers(0, odd.shape[0], int(hit.sum()))]
        return s

    seqs = [upper[rng.integers(0, 20, n)]
            for n in (0, 7, 8, 9, 15, 16, 17, 31, 32, 33)]
    s = residues(40)
    s[0] = high[0]
    seqs.append(s)
    for code in odd[:3]:
        for pos in (0, 7, 8, 39):
            s = upper[rng.integers(0, 20, 40)]
            s[pos] = code
            seqs.append(s)
    seqs += [residues(n) for n in long_lens]
    lens = rng.integers(8, max_len + 1, B - len(seqs))
    plen = np.concatenate([[x.shape[0] for x in seqs], lens]).astype(
        np.int32)
    offsets = np.concatenate([[0], np.cumsum(plen)]).astype(np.int64)
    row_start = np.concatenate(
        [[0], np.cumsum(-(-plen.astype(np.int64) // ALIGN))])
    flat = np.concatenate(seqs + [residues(int(lens.sum()))])
    codes = pack_u8_rows(flat, offsets, plen, row_start,
                         int(row_start[-1]))
    fidx = rng.integers(0, 0xFFFF, B).astype(np.int32)
    sid = rng.permutation(10 * B)[:B].astype(np.int32)
    return (codes, (row_start[:-1] * ALIGN).astype(np.int32), fidx, plen,
            sid)


def select_windows(seed: int, n_random: int = 3000):
    """Window attributes (hi, lo uint32; func, off, plen, sid int32) in a
    shuffled order, grouped by k-mer into the selection's edges:

    - heavy ties in the best count: groups whose top functions share the
      count (equal counts of 2-4 functions, the tied ones in random order
      of index);
    - ktotal at the 80% edge: 4 of 5 and 8 of 10 (kept at threshold 0.8)
      and 7 of 9 (not kept);
    - a group of 1500 occurrences (1300 of one function) and one of 2000
      occurrences split over many functions;
    - lengths up to 65535, offsets over all 16 bits;
    - k-mers whose first code is a lower-case residue >= 32 (bit 63 of the
      packed key) beside upper-case ones;
    - n_random random small groups, singletons included."""
    rng = np.random.default_rng(seed)
    upper, lower, high = _build_codes()
    both = np.concatenate([upper, lower])

    def kmer(first=None):
        c = both[rng.integers(0, both.shape[0], 8)].astype(np.uint64)
        if first is not None:
            c[0] = first
        k = np.uint64(0)
        for x in c:
            k = (k << np.uint64(6)) | x
        return int(k)

    groups = []  # (kmer, [function per occurrence])
    for counts in ((3, 3), (2, 2, 2), (4, 4, 1), (5, 5, 5, 5), (1, 1),
                   (6, 2, 6)):
        funcs = rng.permutation(60)[:len(counts)]
        groups.append((kmer(), [f for f, c in zip(funcs, counts)
                                for _ in range(c)]))
    for best, total in ((4, 5), (8, 10), (7, 9)):
        for first in (None, int(high[-1])):
            f = rng.permutation(50)[:total - best + 1]
            groups.append((kmer(first), [int(f[0])] * best
                           + [int(x) for x in f[1:]]))
    groups.append((kmer(int(high[0])), [17] * 1300
                   + rng.integers(0, 40, 200).tolist()))
    groups.append((kmer(), rng.integers(0, 300, 2000).tolist()))
    for _ in range(n_random):
        first = int(high[rng.integers(0, high.shape[0])]) \
            if rng.random() < 0.3 else None
        size = int(rng.choice([1, 1, 1, 2, 3, 5, 9, 40]))
        main = int(rng.integers(0, 0xFFFF))
        groups.append((kmer(first), [
            main if rng.random() < 0.85 else int(rng.integers(0, 0xFFFF))
            for _ in range(size)]))
    keys = np.concatenate([np.full(len(f), k, np.uint64)
                           for k, f in groups])
    func = np.concatenate([np.asarray(f, np.int64) for _, f in groups])
    n = keys.shape[0]
    big = rng.random(n) < 0.1
    plen = np.where(big, rng.integers(30000, 65536, n),
                    rng.integers(8, 2000, n))
    off = rng.integers(0, 65536, n)
    sid = rng.integers(0, 1 << 24, n)
    order = rng.permutation(n)
    return ((keys[order] >> np.uint64(24)).astype(np.uint32),
            (keys[order] & np.uint64(0xFFFFFF)).astype(np.uint32),
            func[order].astype(np.int32), off[order].astype(np.int32),
            plen[order].astype(np.int32), sid[order].astype(np.int32))


def select_tile_edges(seed: int, tile: int, small: int,
                      n_seqs: int = 5000):
    """Window attributes (hi, lo uint32; func, off, plen, seq int32) in a
    shuffled order whose k-mer groups, once sorted, lie on the selection
    kernel's edges for tiles of ``tile`` entries, groups of at most
    ``small`` entries walked by a thread and a halo of ``small`` entries
    (T below is the tile):

    - a group of exactly one tile at [0, T), one of several tiles from T
      (the tiles wholly inside it own no group);
    - a small and a large group ending on a tile's last entry, and a small
      and a large group starting on a tile's first entry;
    - groups from one entry before a tile edge of ``small`` entries (its
      end, the next group's start, is the halo's last entry) and of
      ``small`` + 1 (it ends past the halo);
    - a small group across the tile edge whose two functions tie, the
      second run in the halo;
    - groups of ``small`` and ``small`` + 1 entries inside a tile;
    - warp-walked groups whose tied runs cross a 32-entry step: 30 + 30 +
      4 (the first run wins) and 10 + 27 + 27 (the second);
    - tiles of singletons only; a group of 45 entries last, ending on N.

    Other groups are singletons or of 2-9 entries; a group's functions
    are one main function with a random share, so that some groups pass
    the 80% rule and some do not.  Lengths up to 65535, offsets over all
    16 bits, k-mers with first codes >= 32 (bit 63 of the packed key);
    seq < n_seqs."""
    rng = np.random.default_rng(seed)
    groups = []  # functions per group, in ascending k-mer order
    size = [0]

    def add(funcs):
        groups.append([int(f) for f in funcs])
        size[0] += len(funcs)

    def some(n):
        main = int(rng.integers(0, 0xFFFF))
        share = rng.choice([1.0, 0.9, 0.8, 0.6])
        return [main if rng.random() < share else int(rng.integers(0, 0xFFFF))
                for _ in range(n)]

    def fill_to(pos):  # singletons and small groups, ending on pos
        while size[0] < pos:
            add(some(min(int(rng.choice([1, 1, 1, 2, 3, 9])),
                         pos - size[0])))

    T = tile
    add(some(T))
    add(some(3 * T + 5))
    fill_to(5 * T - 10)
    add(some(10))                       # ends on tile 4's last entry
    add(some(7))                        # starts on tile 5's first
    fill_to(6 * T - 100)
    add(some(100))                      # large, ends on a tile's last
    add(some(50))                       # large, starts on a tile's first
    fill_to(7 * T - 1)
    add(some(small))                    # to the halo's last entry
    fill_to(8 * T - 1)
    add(some(small + 1))                # past the halo
    fill_to(9 * T - 5)
    add([300] * 10 + [301] * 10)        # a tie, the second run in the halo
    add([7] * 30 + [9] * 30 + [11] * 4)  # ties across a 32-entry step
    add([7] * 10 + [9] * 27 + [11] * 27)
    add(some(small))
    add(some(small + 1))
    fill_to(10 * T)
    for _ in range(2 * T):              # tiles 10 and 11: singletons only
        add(some(1))
    fill_to(12 * T + 300)
    add(some(45))                       # the last group, ending on N

    upper, lower, _ = _build_codes()
    both = np.concatenate([upper, lower]).astype(np.uint64)
    kmers = np.zeros(0, np.uint64)
    while kmers.shape[0] < len(groups):
        c = both[rng.integers(0, both.shape[0], (2 * len(groups), 8))]
        k = np.zeros(c.shape[0], np.uint64)
        for j in range(8):
            k = (k << np.uint64(6)) | c[:, j]
        kmers = np.unique(np.concatenate([kmers, k]))
    kmers = np.sort(rng.choice(kmers, len(groups), replace=False))
    keys = np.repeat(kmers, [len(f) for f in groups])
    func = np.concatenate([np.asarray(f, np.int64) for f in groups])
    n = keys.shape[0]
    plen = np.where(rng.random(n) < 0.1, rng.integers(30000, 65536, n),
                    rng.integers(8, 2000, n))
    off = rng.integers(0, 65536, n)
    seq = rng.integers(0, n_seqs, n)
    order = rng.permutation(n)
    return ((keys[order] >> np.uint64(24)).astype(np.uint32),
            (keys[order] & np.uint64(0xFFFFFF)).astype(np.uint32),
            func[order].astype(np.int32), off[order].astype(np.int32),
            plen[order].astype(np.int32), seq[order].astype(np.int32))


def sparse_sids(n_seqs: int, per_file: int = 3000) -> np.ndarray:
    """Ascending sequence ids file_number * 100000 + n, as the builder
    numbers them (core/config.py's max_seqs_per_file), per_file a file."""
    i = np.arange(n_seqs)
    return ((i // per_file) * 100_000 + i % per_file).astype(np.int32)


def build_corpus(root, n_seqs: int, n_genomes: int = 100,
                 seq_len: int = 300, seed: int = 11, n_lower: int = 0):
    """The build benchmark's corpus on disk (benchmarks/e2e_build_bench.py,
    the reference's 300K-sequence build): n_genomes FASTA files under
    root/Seqs with assignment files under root/Annotations, one protein of
    every family per genome, each family's first half a conserved core
    and its second half random.  The same seed gives the same corpus.
    n_lower of the sequences, chosen by a second generator, are written
    in lower case.  Returns (fasta dir, definitions dir)."""
    from pathlib import Path

    root = Path(root)
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
    n_funcs = n_seqs // n_genomes  # every family once per genome
    rng = np.random.default_rng(seed)
    half = seq_len // 2
    cores = aa[rng.integers(0, 20, (n_funcs, half))]
    lower = np.zeros(n_genomes * n_funcs, bool)
    lower[np.random.default_rng(seed + 1).choice(
        lower.shape[0], n_lower, replace=False)] = True
    fasta_dir = root / "Seqs"
    defs_dir = root / "Annotations"
    fasta_dir.mkdir(parents=True, exist_ok=True)
    defs_dir.mkdir(parents=True, exist_ok=True)
    for g in range(n_genomes):
        gid = f"{1000 + g}.7"
        tails = aa[rng.integers(0, 20, (n_funcs, seq_len - half))]
        seqs = np.concatenate([cores, tails], axis=1)
        low = lower[g * n_funcs:(g + 1) * n_funcs]
        seqs[low] |= 0x20
        fa, defs = [], []
        for i in range(n_funcs):
            fid = f"fig|{gid}.peg.{i + 1}"
            fa.append(f">{fid}\n{seqs[i].tobytes().decode()}\n")
            defs.append(f"{fid}\tSynthetic family protein F{i:05d}\n")
        (fasta_dir / gid).write_text("".join(fa))
        (defs_dir / gid).write_text("".join(defs))
    return fasta_dir, defs_dir


# ---- the rank entry point of multi-process runs ---------------------------

KERNEL_WRAPPERS = (
    ("kmer_pack", "pack_call_windows_rows16"), ("probe", "probe_wide"),
    ("automaton", "device_automaton_packed"), ("probe", "probe_wide_aux"),
    ("probe", "probe_wide_distance"),
    ("build_extract", "build_extract_windows"),
    ("build_select", "build_select_runs"), ("probe", "probe_bucket"),
    ("probe", "probe_bucket_aux"), ("probe", "probe_cmph"),
    ("probe", "probe_cmph_aux"), ("probe", "probe_table"))
PLAIN_VERSIONS = (
    ("kmer_pack", ("expand_rows16", "pack_call_windows_rows16_reference")),
    ("probe", ("probe_wide_reference", "probe_wide_aux_reference",
               "probe_wide_distance_reference", "probe_bucket_reference",
               "probe_bucket_aux_reference", "probe_cmph_reference",
               "probe_cmph_aux_reference", "probe_table_reference")),
    ("automaton", ("device_automaton_reference", "pack_records_reference")),
    ("build_extract", ("build_extract_windows_reference",)),
    ("build_select", ("build_select_runs_reference",)))


def _ops(name):
    import importlib

    return importlib.import_module(f"signature_kmers_tpu_torch.ops.{name}")


def kernel_launches() -> dict:
    """Each kernel wrapper's launch count in this process."""
    return {name: getattr(_ops(mod), name).launches
            for mod, name in KERNEL_WRAPPERS}


def count_plain_versions() -> dict:
    """Counts every later call of a plain version in this process (the
    counts dict is returned and filled in place)."""
    counts = {}
    for mod_name, names in PLAIN_VERSIONS:
        mod = _ops(mod_name)
        for name in names:
            fn = getattr(mod, name)
            counts[name] = 0

            def counted(*a, _fn=fn, _name=name, **kw):
                counts[_name] += 1
                return _fn(*a, **kw)

            setattr(mod, name, counted)
    return counts


def mp_workload():
    """The JAX package's multi-process workload (tests/drivers/
    mp_driver.py): a 30,000-k-mer wide table of 50 functions, 96 mutated
    200-residue queries and a 64-sequence build chunk, from seed 42.
    -> (table, function_index, batch, chunk)."""
    from .core import alphabet
    from .io.fasta import SequenceBatch
    from .table.kmer_table import pack_values
    from .table.wide_table import WideKmerTable

    rng = np.random.default_rng(42)
    aa = alphabet.encode_seq(alphabet.AA20)
    n_k = 30_000
    corpus = aa[rng.integers(0, 20, n_k + 7)].astype(np.uint8)
    hi, lo = alphabet.pack_codes_np(corpus)
    fn_of = ((np.arange(hi.shape[0]) // 200) % 50).astype(np.uint32)
    pk = (hi.astype(np.uint64) << 24) | lo
    _, idx = np.unique(pk, return_index=True)
    idx.sort()
    hi, lo, fn = hi[idx], lo[idx], fn_of[idx]
    n = hi.shape[0]
    v0, v1, v2 = pack_values(
        rng.integers(0, 200, n), fn, np.full(n, 200, np.uint32),
        np.full(n, 200, np.uint32), np.full(n, 400, np.uint32))
    table = WideKmerTable.build(hi, lo, v0.astype(np.uint32),
                                v1.astype(np.uint32), v2.astype(np.uint32))
    function_index = [f"fn{i}" for i in range(50)] + ["hypothetical protein"]
    n_q, L = 96, 200
    starts = rng.integers(0, n_k - L, n_q)
    codes = np.stack([corpus[s:s + L] for s in starts]).copy()
    for q in range(n_q):
        pos = rng.integers(0, L, 6)
        codes[q, pos] = aa[rng.integers(0, 20, 6)]
    batch = SequenceBatch(
        codes.reshape(-1), (np.arange(n_q + 1) * L).astype(np.int32),
        [f"q{i}" for i in range(n_q)], [""] * n_q)
    B = 64
    plens = rng.integers(8, 120, B).astype(np.int32)
    bcodes = aa[rng.integers(0, 6, int(plens.sum()))].astype(np.uint8)
    chunk = (bcodes, np.arange(B, dtype=np.int32),
             ((np.arange(B) // 4) % 7).astype(np.int32), plens)
    return table, function_index, batch, chunk


def kept_digest(kept, stats) -> dict:
    """A kept set and its statistics, comparable across packages: each
    field's sha256 over int64 values, and the statistics."""
    import dataclasses
    import hashlib

    out = {f.name: hashlib.sha256(np.asarray(getattr(kept, f.name),
                                             np.int64).tobytes()).hexdigest()
           for f in dataclasses.fields(kept)}
    out["n"] = int(len(kept))
    out["distinct_signatures"] = int(stats.distinct_signatures)
    out["seqs_with_a_signature"] = hashlib.sha256(np.sort(np.asarray(
        list(stats.seqs_with_a_signature), np.int64)).tobytes()).hexdigest()
    out["distinct_functions"] = hashlib.sha256(np.asarray(sorted(
        stats.distinct_functions.items()), np.int64).tobytes()).hexdigest()
    return out


def _rows(results) -> str:
    from .io import formats

    return "".join(formats.format_call_row(
        r.seq_id, r.best.function, r.best.function_index, r.best.score)
        for r in results)


def mesh_job(spec: dict) -> dict:
    """The mesh programs on a mesh over every rank's cells (spec["cells"]
    cells of spec["device"] a rank, tp spec["tp"]): the call of
    spec["queries"] against spec["data_dir"] (or of the mp workload), the
    selection of spec["corpus_npz"]'s concatenated corpus (or of the mp
    chunk; at tp spec["build_tp"] when given), sharded_score_cutoff of
    spec["cutoff"] seeded scores and
    MatrixDistance.compute(mesh=) of spec["distance"].  -> results."""
    import time

    import torch

    from .core.config import Config, DeviceConfig
    from .io.fasta import read_fasta_batch
    from .models import pipeline
    from .models.matrix_distance import MatrixDistance
    from .models.signature_builder import SignatureBuilder
    from .parallel import build_step, distributed
    from .parallel.mesh import make_mesh
    from .parallel.parallel_caller import ParallelFunctionCaller
    from .stats.natural_breaks import sharded_score_cutoff

    device = torch.device(spec.get("device", "cpu"))
    assert distributed.initialize(device=device.type)
    mesh = make_mesh(tp=spec.get("tp"),
                     devices=[device] * spec.get("cells", 1))
    out = {"spans": distributed.is_multiprocess_mesh(mesh),
           "shape": mesh.shape, "ranks": [list(r) for r in mesh.ranks]}
    out["shard_inputs"] = distributed.shard_inputs(list(range(10)))
    cfg = Config()
    dc = DeviceConfig(call_batch=spec.get("call_batch",
                                          cfg.device.call_batch))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    chunk = None
    if spec.get("workload") == "mp":
        table, fi, batch, chunk = mp_workload()
    elif spec.get("data_dir"):
        table, fi = pipeline.load_data_dir(spec["data_dir"])
        batch = read_fasta_batch(spec["queries"])
    else:
        table = None
    if table is not None:
        t0 = time.perf_counter()
        pc = ParallelFunctionCaller(table, fi, cfg.call, dc, mesh=mesh)
        out["shard_s"] = time.perf_counter() - t0
        secs = []
        for _ in range(spec.get("repeats", 1)):
            distributed.barrier("mesh-call")
            t0 = time.perf_counter()
            res = pc.call_batch(batch)
            sync()
            secs.append(time.perf_counter() - t0)
        out["rows"] = _rows(res)
        out["call_s"] = secs
        out["seqs"] = len(batch)
        del pc, table
    if spec.get("corpus_npz"):
        with np.load(spec["corpus_npz"]) as z:
            chunk = tuple(z[k] for k in ("codes", "sids", "fidxs", "plens"))
    if chunk is not None:
        if "build_tp" in spec:
            mesh = make_mesh(tp=spec["build_tp"],
                             devices=[device] * spec.get("cells", 1))
            out["build_shape"] = mesh.shape
        sb = SignatureBuilder(device=device)
        sb._seq_chunks.append(chunk)
        distributed.barrier("mesh-build")
        sync()
        t0 = time.perf_counter()
        kept = sb.process_kmers(mesh=mesh)
        sync()
        out["process_kmers_s"] = time.perf_counter() - t0
        out["kept"] = kept_digest(kept, sb.stats)
        out["exchange"] = dict(build_step.exchange_stats)
        g = mesh.all_group()
        if g is not None and spec.get("loopback"):
            # the host's loopback rate: an all_to_all of as many bytes as
            # this rank sent in the exchange, between the ranks as CPU
            # tensors over gloo, split evenly; the faster of two (the
            # first touches fresh pages)
            n = max(out["exchange"].get("rank_bytes", 0) // 4, 1 << 20)
            x = torch.zeros(n, dtype=torch.int32)
            split = [n // g.size] * (g.size - 1)
            split.append(n - sum(split))
            secs = []
            for _ in range(2):
                distributed.barrier("loopback")
                t0 = time.perf_counter()
                distributed.all_to_all_uneven(x, split, g, control=True)
                secs.append(time.perf_counter() - t0)
            out["loopback_bytes"] = 4 * n
            out["loopback_s"] = min(secs)
    if spec.get("cutoff"):
        c = spec["cutoff"]
        rng = np.random.default_rng(c["seed"])
        scores = np.concatenate([rng.normal(0.2, 0.05, c["n"] // 2),
                                 rng.normal(0.7, 0.1, c["n"] - c["n"] // 2)])
        out["cutoff"] = sharded_score_cutoff(mesh, scores.astype(np.float32),
                                             k=c.get("k", 2))
    if spec.get("distance"):
        table, fi = pipeline.load_data_dir(spec["data_dir_distance"])
        md = MatrixDistance(table, fi, cfg.distance, cfg.device,
                            device=device)
        res = md.compute([read_fasta_batch(spec["distance"])], mesh=mesh)
        out["distance"] = [list(r) for r in res.rows(with_score=True)]
    return out


def rank_main(argv=None) -> int:
    """python -m signature_kmers_tpu_torch.testing [--strict] cli ARGS...
       python -m signature_kmers_tpu_torch.testing [--strict] mesh SPEC.json

    One rank of a multi-process run (SKT_COORDINATOR, SKT_NUM_PROCESSES,
    SKT_PROCESS_ID in the environment): the port's CLI with ARGS, or
    mesh_job(SPEC) with its results written to SPEC's "out" + ".<rank>".
    Prints "MP_RANK <json>" last: the rank, its exit code, its kernel
    launches, the plain versions that ran, its peak device memory and
    seconds.  --strict exits non-zero when a plain version ran."""
    import json
    import sys
    import time

    import torch

    args = list(sys.argv[1:] if argv is None else argv)
    strict = args[:1] == ["--strict"]
    if strict:
        args = args[1:]
    plain = count_plain_versions()
    t0 = time.perf_counter()
    from .parallel import distributed

    rank = int(__import__("os").environ.get("SKT_PROCESS_ID", "0"))
    rc = 0
    try:
        if args[0] == "cli":
            from .cli.main import main as cli_main

            try:
                rc = cli_main(args[1:]) or 0
            except SystemExit as e:
                rc = e.code if isinstance(e.code, int) else 1
                if not isinstance(e.code, int):
                    print(e.code, file=sys.stderr)
        else:
            spec = json.loads(open(args[1]).read())
            res = mesh_job(spec)
            with open(f"{spec['out']}.{distributed.process_index()}",
                      "w") as fh:
                json.dump(res, fh)
            distributed.shutdown()
    finally:
        report = {"rank": rank, "rc": rc, "launches": kernel_launches(),
                  "plain": {k: v for k, v in plain.items() if v},
                  "seconds": time.perf_counter() - t0,
                  "peak_mib": (torch.cuda.max_memory_allocated() / 2**20
                               if torch.cuda.is_available() else 0.0)}
        print("MP_RANK " + json.dumps(report), flush=True)
    if strict and report["plain"]:
        return 3
    return rc


if __name__ == "__main__":
    import sys

    sys.exit(rank_main())
