"""Build-side selection: the sorts, then one pass over the sorted windows.

select_compact takes build_extract_windows' (key_f, key_o, plen, seq) and
the sequence ids, and returns the kept signatures as four uint32 words
each (in int32 bit containers, ascending packed k-mer) and the ascending
ids of the sequences that contribute to any kept k-mer:

    w0 = kmer48 >> 16            w1 = (kmer48 & 0xFFFF) << 16 | function
    w2 = mean << 16 | median     w3 = var << 16 | avg_from_end

the JAX package's _select_compact_jax words.  The sorts are torch.sort:
sort 1 orders the windows by (k-mer, function, length), the length by a
prior stable sort on it (LSD order), then a stable sort on key_f; sort 2
orders key_o, (k-mer, offset), for avg_from_end.  The keys carry a flipped
sign bit (ops/build_extract.py), so the signed sort is the unsigned order.
The payload through the sort is a dense sequence index (seq < n_seqs),
never the sparse sequence id, so the kept sequences come back as one flag
byte per sequence.  build_select_runs is the pass over the k-mer groups
and their compaction (kernel: csrc/build_select.cu); its plain version
below follows the JAX package's host twin _select_np: run starts by
comparing neighbours, segment reductions by scatter_reduce and cumsum,
_finalize_stats_np's int64 statistics, then a boolean compaction and a
flag scatter.
"""

from __future__ import annotations

import torch

from . import cuda_launch as cl
from .build_extract import key_kmer


# csrc/build_select.cu's tile: a block owns the k-mer groups whose first
# entry lies in its TILE entries, and one thread walks a group of at most
# SMALL entries (the tests put groups on these edges)
TILE = 1024
SMALL = 32


def sort_windows(key_f: torch.Tensor, key_o: torch.Tensor,
                 plen: torch.Tensor, seq: torch.Tensor):
    """The two sorts -> (k1s, plen_s, seq_s, k2s): key_f in (k-mer,
    function, length) order with the lengths and sequence indices beside
    it, and key_o sorted."""
    order = torch.sort(plen, stable=True).indices
    k1s, o1 = torch.sort(key_f[order], stable=True)
    perm = order[o1]
    del order, o1
    k2s = torch.sort(key_o).values
    return k1s, plen[perm], seq[perm], k2s


def _group_starts(k1s: torch.Tensor) -> torch.Tensor:
    """(G,) int64 first index of each k-mer group of the sorted keys."""
    km = k1s >> 16
    first = torch.ones(k1s.shape[0], dtype=torch.bool, device=k1s.device)
    first[1:] = km[1:] != km[:-1]
    return torch.nonzero(first).squeeze(1)


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> their int32 bit containers."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def finalize_stats(n, s, sq, med_lo, med_hi):
    """_finalize_stats_np on int64 tensors: mean, median and variance
    floors of the best run's lengths, each & 0xFFFF (int64)."""
    c = torch.div(s, n, rounding_mode="floor")
    d2 = sq - 2 * c * s + n * c * c
    r = s - c * n
    var = torch.div(n * d2 - r * r, n * n, rounding_mode="floor")
    return (c & 0xFFFF, torch.div(med_lo + med_hi, 2,
                                  rounding_mode="floor") & 0xFFFF,
            var & 0xFFFF)


def build_select_runs_reference(k1s: torch.Tensor, plen_s: torch.Tensor,
                                k2s: torch.Tensor, seq_s: torch.Tensor,
                                n_seqs: int, threshold: float):
    """Plain version of build_select_runs."""
    dev = k1s.device
    N = k1s.shape[0]
    flags = torch.zeros(n_seqs, dtype=torch.uint8, device=dev)
    if N == 0:
        return torch.zeros((0, 4), dtype=torch.int32, device=dev), flags
    starts = _group_starts(k1s)
    G = starts.shape[0]
    ends = torch.cat([starts[1:], torch.tensor([N], device=dev)])
    ktotal = ends - starts
    gid = torch.repeat_interleave(torch.arange(G, device=dev), ktotal)
    f = k1s & 0xFFFF
    pstart = torch.ones(N, dtype=torch.bool, device=dev)
    pstart[1:] = (gid[1:] != gid[:-1]) | (f[1:] != f[:-1])
    pidx = torch.nonzero(pstart).squeeze(1)
    pair_count = torch.diff(pidx, append=torch.tensor([N], device=dev))
    pair_gid = gid[pidx]
    best_count = torch.zeros(G, dtype=torch.int64, device=dev).scatter_reduce(
        0, pair_gid, pair_count, "amax", include_self=False)
    npairs = pidx.shape[0]
    cand = torch.where(pair_count == best_count[pair_gid],
                       torch.arange(npairs, device=dev), npairs)
    best_pair = torch.full((G,), npairs, dtype=torch.int64,
                           device=dev).scatter_reduce(
        0, pair_gid, cand, "amin", include_self=False)
    sbe = pidx[best_pair]
    best_func = f[sbe]
    keep = ~(best_count.to(torch.float32)
             < ktotal.to(torch.float32)
             * torch.tensor(threshold, dtype=torch.float32, device=dev))

    p = plen_s.to(torch.int64)
    cs = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    cs[1:] = torch.cumsum(p, 0)
    csq = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    csq[1:] = torch.cumsum(p * p, 0)
    n = best_count
    mean16, median16, var16 = finalize_stats(
        n, cs[sbe + n] - cs[sbe], csq[sbe + n] - csq[sbe],
        p[sbe + torch.div(n - 1, 2, rounding_mode="floor")],
        p[sbe + torch.div(n, 2, rounding_mode="floor")])
    avg = k2s[starts + torch.div(ktotal, 2, rounding_mode="floor")] & 0xFFFF
    kmer = key_kmer(k1s[starts])
    words = torch.stack([
        _as_int32(kmer >> 16),
        _as_int32(((kmer & 0xFFFF) << 16) | best_func),
        _as_int32((mean16 << 16) | median16),
        _as_int32((var16 << 16) | avg)], dim=1)
    kept_seq = seq_s[keep[gid]].to(torch.int64)
    if bool(((kept_seq < 0) | (kept_seq >= n_seqs)).any()):
        raise ValueError(f"seq_s: a kept entry's index outside [0, {n_seqs})")
    flags[kept_seq] = 1
    return words[keep], flags


def build_select_runs(k1s: torch.Tensor, plen_s: torch.Tensor,
                      k2s: torch.Tensor, seq_s: torch.Tensor, n_seqs: int,
                      threshold: float):
    """Sorted windows -> (words (n_kept, 4) int32, flags (n_seqs,) uint8):
    the four words (module docstring) of each group kept by the 80% rule
    at ``threshold`` (in float32), in ascending k-mer order, and a 1 for
    each sequence with an entry in a kept group.

    k1s, k2s: (N,) int64 (sort_windows); plen_s, seq_s: (N,) int32, each
    seq_s in [0, n_seqs) (a kept entry's index outside it raises).  On the
    card the kept count is read back once, to cut words to it."""
    if not cl.on_cuda(k1s, plen_s, k2s, seq_s):
        return build_select_runs_reference(k1s, plen_s, k2s, seq_s, n_seqs,
                                           threshold)
    N = k1s.shape[0]
    cl.check(k1s, "k1s", torch.int64, (N,))
    cl.check(plen_s, "plen_s", torch.int32, (N,))
    cl.check(k2s, "k2s", torch.int64, (N,))
    cl.check(seq_s, "seq_s", torch.int32, (N,))
    cl.check_aligned(16, k1s=k1s, plen_s=plen_s, k2s=k2s, seq_s=seq_s)
    dev = k1s.device
    words = torch.empty((N, 4), dtype=torch.int32, device=dev)
    flags = torch.zeros(n_seqs, dtype=torch.uint8, device=dev)
    if N == 0:
        return words, flags
    scratch = select_scratch(N, dev)
    launch_select(k1s, plen_s, k2s, seq_s, threshold, words, flags, scratch)
    build_select_runs.launches += 1
    n_kept, bad = scratch[[1, -1]].tolist()
    if bad:
        raise ValueError(f"seq_s: a kept entry's index outside [0, {n_seqs})")
    return words[:n_kept], flags


build_select_runs.launches = 0


def select_scratch(N: int, device) -> torch.Tensor:
    """build_select_runs' zeroed scratch: tile ids, the kept count, a
    look-back status word per tile (csrc/lookback.cuh), then the word the
    kernel sets on an out-of-range sequence index.  The entry point
    refuses a shorter one."""
    return torch.zeros(3 + -(-N // TILE), dtype=torch.int64, device=device)


def launch_select(k1s, plen_s, k2s, seq_s, threshold, words, flags,
                  scratch) -> None:
    """The kernel's launch into the given outputs and zeroed scratch (the
    wrapper's, and its timing alone); the count is scratch[1]."""
    cl.launch("build_select_runs",
              [k1s.data_ptr(), plen_s.data_ptr(), k2s.data_ptr(),
               seq_s.data_ptr(), k1s.shape[0], flags.shape[0], threshold,
               words.data_ptr(), flags.data_ptr(), scratch.data_ptr(),
               scratch.shape[0]], k1s.device)


def kept_sids(flags: torch.Tensor, sids: torch.Tensor) -> torch.Tensor:
    """The ids of the flagged sequences, in the order of sids."""
    return sids[torch.nonzero(flags).squeeze(1)]


def select_compact(key_f: torch.Tensor, key_o: torch.Tensor,
                   plen: torch.Tensor, seq: torch.Tensor, threshold: float,
                   sids: torch.Tensor):
    """Windows -> (words (n_kept, 4) int32, the kept sequences' ids
    (int32, ascending)): the two sorts and build_select_runs.

    seq: (N,) int32, each window's index into sids, (B,) int32 ascending
    sequence ids."""
    k1s, plen_s, seq_s, k2s = sort_windows(key_f, key_o, plen, seq)
    words, flags = build_select_runs(k1s, plen_s, k2s, seq_s,
                                     sids.shape[0], threshold)
    return words, kept_sids(flags, sids)
