"""Inputs on the edges of the kernels' tilings, made from a seed with numpy.

One generator for every place that holds a kernel or a plain version to
another: ``chip_smoke.py`` phase 2 and ``tests/test_torch_kernels_cuda.py``
(kernel against plain version on the card) and the CPU tests (plain version
against the JAX package).  The automaton kernel runs one warp per row over
steps of 32 windows; the probe kernel takes 4 windows per thread.
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
