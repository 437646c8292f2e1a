"""The sharded build step on a (dp, tp) mesh of one process.

Scheme (the collective form of the reference's single-process TBB
multimap, signature_build.h:61):

  1. each dp shard takes a contiguous, row-balanced slice of the corpus
     (pack_corpus_sharded) and extracts its valid windows with kernel 6
     (ops/build_extract.py) on its own cell;
  2. the windows are routed to their k-mer's owner shard (the top
     log2(dp) bits of hash_kmer; every window to shard 0 when dp is 1):
     a stable order by owner, the bucket counts, and a gather of each
     (source, owner) bucket, sized by its count;
  3. the exchange: each owner receives its buckets from every source in
     source order (a copy to the owner's cell, none where the cells share
     a device), so a k-mer's whole occurrence set lands on one shard and
     its statistics are exact;
  4. each owner runs the one-device selection on what it received: the
     two sorts and kernel 7 (ops/build_select.py), which returns the kept
     signatures' words in k-mer order and a flag per sequence;
  5. finalize_sharded merges the owners' words on the first cell (one
     sort by k-mer: owners hold disjoint k-mer sets in hash order) and
     unpacks them on the host.

The windows carry a sequence index that is global over the corpus, so
the owners' flags index one sequence-id array.  With tp > 1 each dp row
runs on its first cell.  bucket_cap keeps the JAX package's meaning: an
entry whose rank in its (source, owner) bucket is cap or more is dropped.
The windows travel as build_extract's sort keys: key_f and key_o (int64),
plen and seq (int32), 24 bytes each.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import build_extract, build_select, hashing, kmer_pack
from .mesh import dp_cells

SENTINEL = np.uint32(0xFFFFFF)  # > max valid word 0xCF3CF3 (4x code 51)


@dataclasses.dataclass
class ShardedSelection:
    """build_step_*'s result: each owner shard's kept words ((n, 4)
    int32, ascending k-mer) and sequence flags ((n_seqs,) uint8), on its
    cell, and the sequence id of each global sequence index."""

    words: list
    flags: list
    sids: np.ndarray


def _grid(x: int, lo: int = 256) -> int:
    """The JAX package's shape grid: pow2 or 1.5 * pow2, at least lo."""
    g = lo
    while g < x:
        g <<= 1
    if g > lo and (g >> 1) + (g >> 2) >= x:
        g = (g >> 1) + (g >> 2)
    return g


def pack_corpus_sharded(codes, sids, fidxs, plens, ndp: int):
    """Host: split the sequences into ndp contiguous row-balanced groups
    and pack each as 16-code-aligned 8-bit rows (kmer_pack.pack_u8_rows).

    Returns (packed (ndp, Rl*16) uint8, starts (ndp, Bg) int32,
    meta (ndp, 3, Bg) int32 [fidx, plen, sid]); padding rows are
    INVALID codes, padding entries start at Rl*16 with length 0."""
    B = plens.shape[0]
    spans = -(-plens.astype(np.int64) // kmer_pack.ALIGN)
    row_cum = np.cumsum(spans)
    total = int(row_cum[-1]) if B else 0
    targets = (np.arange(1, ndp) * total) // max(ndp, 1)
    # side="right": a sequence whose cumulative row count lands exactly on
    # a target stays in the left group
    bounds = np.concatenate(
        [[0], np.searchsorted(row_cum, targets, side="right"), [B]])
    seq_off = np.zeros(B + 1, np.int64)
    np.cumsum(plens, out=seq_off[1:])

    group_rows = [int(row_cum[b - 1] - (row_cum[a - 1] if a else 0))
                  if b > a else 0
                  for a, b in zip(bounds[:-1], bounds[1:])]
    Rl = _grid(max(group_rows))
    Bg = _grid(int((bounds[1:] - bounds[:-1]).max()))
    n_loc = Rl * kmer_pack.ALIGN

    packed = np.empty((ndp, n_loc), np.uint8)
    starts = np.full((ndp, Bg), n_loc, np.int32)
    meta = np.zeros((ndp, 3, Bg), np.int32)
    for g in range(ndp):
        a, b = int(bounds[g]), int(bounds[g + 1])
        pl = plens[a:b]
        rs = np.zeros(b - a + 1, np.int64)
        np.cumsum(spans[a:b], out=rs[1:])
        packed[g] = kmer_pack.pack_u8_rows(codes, seq_off[a:b], pl, rs, Rl)
        starts[g, :b - a] = rs[:-1] * kmer_pack.ALIGN
        meta[g, 0, :b - a] = fidxs[a:b]
        meta[g, 1, :b - a] = pl
        meta[g, 2, :b - a] = sids[a:b]
    return packed, starts, meta


def upload_shard(cell, packed_g, starts_g, fidx_g, plen_g):
    """One shard's rows and sequences on its cell: the sequences that
    start inside the rows (the others are padding, without windows) and
    the rows up to the last one they use."""
    n_loc = packed_g.shape[0]
    nb = int((starts_g < n_loc).sum())
    st, fi, pl = starts_g[:nb], fidx_g[:nb], plen_g[:nb]
    A = kmer_pack.ALIGN
    used = int((st.astype(np.int64) + -(-pl.astype(np.int64) // A) * A)
               .max()) if nb else 0
    put = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(cell)
    return (put(packed_g[:used]), put(st.astype(np.int32)),
            put(fi.astype(np.int32)), put(pl.astype(np.int32)))


def extract_shard(rows, starts, fidx, plen, seq_base: int):
    """Kernel 6 on one shard -> its windows (key_f, key_o, plen, seq),
    seq made global by seq_base."""
    if starts.shape[0] == 0:
        e64 = torch.zeros(0, dtype=torch.int64, device=rows.device)
        e32 = torch.zeros(0, dtype=torch.int32, device=rows.device)
        return e64, e64, e32, e32
    kf, ko, pw, sw = build_extract.build_extract_windows(rows, starts, fidx,
                                                         plen)
    return kf, ko, pw, sw + seq_base


def owners(key_f: torch.Tensor, ndp: int) -> torch.Tensor:
    """Each window's owner shard: the top floor(log2(ndp)) bits of its
    k-mer's hash_kmer (int64; 0 for every window when ndp is 1)."""
    if ndp == 1:
        return torch.zeros(key_f.shape[0], dtype=torch.int64,
                           device=key_f.device)
    km = build_extract.key_kmer(key_f)
    bits = ndp.bit_length() - 1
    return hashing.hash_kmer_t(km >> 24, km & 0xFFFFFF) >> (32 - bits)


def route(windows, ndp: int, cap: int | None = None, keep=None):
    """One source shard's windows -> [the (key_f, key_o, plen, seq) bucket
    of each owner], each in the source's order: a stable order by owner,
    the bucket counts (one read), then a gather per bucket of at most cap
    entries.  keep: an optional mask of the entries that travel, applied
    after the cap (a dropped entry still holds its rank)."""
    owner = owners(windows[0], ndp)
    counts = torch.bincount(owner, minlength=ndp).tolist()
    order = torch.sort(owner, stable=True).indices
    del owner
    buckets, a = [], 0
    for n in counts:
        idx = order[a:a + (n if cap is None else min(n, cap))]
        a += n
        if keep is not None:
            idx = idx[keep[idx]]
        buckets.append(tuple(w[idx] for w in windows))
    return buckets


def exchange(buckets, cells) -> list:
    """buckets[s][o] (source s's bucket for owner o) -> what each owner
    receives: the four fields of its buckets from every source, in
    source order, on its cell."""
    return [tuple(torch.cat([buckets[s][o][f].to(cells[o])
                             for s in range(len(buckets))])
                  for f in range(4))
            for o in range(len(cells))]


def _route_and_select(windows: list, cells, n_seqs: int, cap,
                      threshold: float, keep=None) -> tuple[list, list]:
    """Route every source's windows, exchange, select on each owner.
    Empties windows as it goes: each source's windows are freed once
    they are in its buckets."""
    ndp = len(cells)
    buckets = []
    for s in range(len(windows)):
        buckets.append(route(windows[s], ndp, cap,
                             None if keep is None else keep[s]))
        windows[s] = None
    received = exchange(buckets, cells)
    del buckets
    words, flags = [], []
    for o in range(ndp):
        # the sorts and kernel 7 on what the owner received
        k1s, plen_s, seq_s, k2s = build_select.sort_windows(*received[o])
        received[o] = None
        w, f = build_select.build_select_runs(k1s, plen_s, k2s, seq_s,
                                              n_seqs, threshold)
        words.append(w)
        flags.append(f)
    return words, flags


def build_step_sharded(mesh, hi, lo, func, off, plen, sid,
                       threshold: float = 0.8,
                       bucket_cap: int | None = None) -> ShardedSelection:
    """The sharded selection from window attributes: global flat arrays
    whose length the dp size divides, shard s taking the s-th contiguous
    slice.  An entry with hi == SENTINEL is padding; one with func < 0
    holds its bucket rank and is dropped after the cap."""
    cells = dp_cells(mesh)
    ndp = len(cells)
    n = int(hi.shape[0])
    assert n % ndp == 0, (n, ndp)
    n_local = n // ndp
    sids, seq = np.unique(np.asarray(sid), return_inverse=True)
    windows, keep = [], []
    for s, cell in enumerate(cells):
        sl = slice(s * n_local, (s + 1) * n_local)
        h = np.asarray(hi[sl], np.uint32)
        valid = h != SENTINEL
        put = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(np.asarray(a)[sl][valid])
            .astype(np.int64)).to(cell)
        kmer = (put(hi) << 24) | put(lo)
        f = put(func)
        windows.append((build_extract.window_keys(kmer, f),
                        build_extract.window_keys(kmer, put(off)),
                        put(plen).to(torch.int32), put(seq).to(torch.int32)))
        keep.append(f >= 0)
    words, flags = _route_and_select(windows, cells, sids.shape[0],
                                     bucket_cap, threshold, keep)
    return ShardedSelection(words, flags, sids)


def build_step_from_seqs_arrays(mesh, packed, starts, fidxs, plens, sids,
                                threshold: float = 0.8,
                                bucket_cap: int | None = None
                                ) -> ShardedSelection:
    """The sharded selection from pack_corpus_sharded's stacked arrays:
    packed (ndp, Rl*16), starts, fidxs, plens, sids (ndp, Bg).  Kernel 6
    per shard on its cell, then the routing, the exchange and kernel 7
    per owner.  The global sequence index of shard s's b-th entry is
    s * Bg + b."""
    cells = dp_cells(mesh)
    Bg = starts.shape[1]
    windows = [extract_shard(*upload_shard(cell, packed[s], starts[s],
                                           fidxs[s], plens[s]), s * Bg)
               for s, cell in enumerate(cells)]
    words, flags = _route_and_select(windows, cells, len(cells) * Bg,
                                     bucket_cap, threshold)
    return ShardedSelection(words, flags, np.asarray(sids).reshape(-1))


def build_step_from_seqs(mesh, codes, sids, fidxs, plens,
                         threshold: float = 0.8,
                         bucket_cap: int | None = None) -> ShardedSelection:
    """The sharded selection from the raw corpus: the sequences split
    over the dp shards as 8-bit rows (pack_corpus_sharded), 1 byte per
    residue up to each shard's cell, the windows extracted there."""
    packed, starts, meta = pack_corpus_sharded(codes, sids, fidxs, plens,
                                               mesh.shape["dp"])
    return build_step_from_seqs_arrays(mesh, packed, starts, meta[:, 0],
                                       meta[:, 1], meta[:, 2], threshold,
                                       bucket_cap)


def merge_words(words: list, device) -> torch.Tensor:
    """The owners' kept words on one device, in ascending k-mer order
    (each owner's are; their k-mer sets are disjoint)."""
    w = torch.cat([x.to(device) for x in words])
    if len(words) == 1:
        return w
    u = w[:, :2].to(torch.int64) & 0xFFFF_FFFF
    return w[torch.sort((u[:, 0] << 16) | (u[:, 1] >> 16)).indices]


def finalize_sharded(outputs: ShardedSelection) -> dict:
    """The kept arrays (hi, lo, avg_from_end, function_index, mean,
    median, var), sorted by k-mer: the owners' words merged on the first
    cell, fetched once and unpacked on the host."""
    from ..models.signature_builder import kept_from_words

    dev = outputs.words[0].device
    kept = kept_from_words(merge_words(outputs.words, dev).cpu().numpy())
    return {f.name: getattr(kept, f.name) for f in dataclasses.fields(kept)}


def kept_sids(outputs: ShardedSelection) -> np.ndarray:
    """The ids of the sequences with an entry in a kept group on any
    owner, in sequence-index order."""
    dev = outputs.flags[0].device
    any_kept = torch.zeros(outputs.flags[0].shape[0], dtype=torch.bool,
                           device=dev)
    for f in outputs.flags:
        any_kept |= f.to(dev).bool()
    return outputs.sids[any_kept.cpu().numpy()]
