"""The sharded build step on a (dp, tp) mesh, of one process or spanning
processes.

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
     source order, as one 24-byte record a window (an all_to_all_uneven,
     the identity in one process), so a k-mer's whole occurrence set
     lands on one shard and its statistics are exact;
  4. each owner runs the one-device selection on what it received: the
     two sorts and kernel 7 (ops/build_select.py), which returns the kept
     signatures' words in k-mer order and a flag per sequence;
  5. finalize_sharded merges the owners' words on the first cell (one
     sort by k-mer: owners hold disjoint k-mer sets in hash order) and
     unpacks them on the host.

The windows carry a sequence index that is global over the corpus, so
the owners' flags index one sequence-id array.  With tp > 1 each dp row
runs on its first cell.

On a mesh that spans processes every rank packs the same corpus, extracts
and routes the sources whose first cell it owns, and the exchange runs
between ranks: an all_to_all_uneven of the (source, owner) counts over
the control plane, then one of the records over the device plane; each
owner rank runs the sorts and kernel 7 on what it received.  finalize_sharded and kept_sids bring every owner's
words and flags to every rank (fetch_global), so every rank finalizes the
same kept set.  Ranks of a row but not its first cell take part with
empty splits.  bucket_cap keeps the JAX package's meaning: an
entry whose rank in its (source, owner) bucket is cap or more is dropped.
The windows travel as build_extract's sort keys: key_f and key_o (int64),
plen and seq (int32), 24 bytes each.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..ops import build_extract, build_select, hashing, kmer_pack
from . import distributed
from .mesh import dp_cells

SENTINEL = np.uint32(0xFFFFFF)  # > max valid word 0xCF3CF3 (4x code 51)


# the last exchange: bytes sent (all ranks' records, this rank's, and the
# part of this rank's that left it) and this rank's seconds in the
# records' all_to_all (read by chip_smoke.py's phases 3i and 3j)
exchange_stats: dict = {}


@dataclasses.dataclass
class ShardedSelection:
    """build_step_*'s result: each owner shard's kept words ((n, 4)
    int32, ascending k-mer) and sequence flags ((n_seqs,) uint8), on its
    cell (None where another process owns the shard), the sequence id of
    each global sequence index, and the mesh."""

    words: list
    flags: list
    sids: np.ndarray
    mesh: object = None


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


RECORD_WORDS = 6  # key_f, key_o (two int32 words each), plen, seq


def _pack_records(w) -> torch.Tensor:
    """(key_f, key_o, plen, seq) -> (n, 6) int32 records."""
    n = w[0].shape[0]
    return torch.cat([w[0].view(torch.int32).view(n, 2),
                      w[1].view(torch.int32).view(n, 2),
                      w[2].view(n, 1), w[3].view(n, 1)], dim=1)


def _unpack_records(r: torch.Tensor) -> tuple:
    n = r.shape[0]
    return (r[:, 0:2].contiguous().view(torch.int64).view(n),
            r[:, 2:4].contiguous().view(torch.int64).view(n),
            r[:, 4].contiguous(), r[:, 5].contiguous())


def exchange(mesh, buckets: dict) -> dict:
    """buckets[s][o] (this process's source s, any owner o) -> {owner o of
    this process: the four fields of its buckets from every source, in
    source order, on o's cell}.  First the (source, owner) counts go to
    each owner's rank (all_to_all_uneven over the control plane: they are
    the split sizes), then the windows as (n, 6) int32 records in one
    all_to_all_uneven over the device plane, from this process's first
    cell.  In one process both are the identity: the records are packed
    and unpacked on the cells.  Empties buckets once they are packed."""
    ndp = mesh.shape["dp"]
    g = mesh.all_group() or distributed.Group((distributed.process_index(),))
    owner_rank = [mesh.ranks[o][0] for o in range(ndp)]
    me = distributed.process_index()
    mine = sorted(buckets)
    home = mesh.home
    # what goes to each rank q: for each owner of q, each of my sources
    pieces, counts, splits = [], [], []
    for q in g.ranks:
        n_q = 0
        for o in range(ndp):
            if owner_rank[o] != q:
                continue
            for s in mine:
                b = buckets[s][o]
                counts.append(b[0].shape[0])
                n_q += b[0].shape[0]
                pieces.append(_pack_records(b).to(home))
        splits.append(n_q)
    buckets.clear()
    per_q = [sum(1 for o in range(ndp) if owner_rank[o] == q) * len(mine)
             for q in g.ranks]
    got_n, _ = distributed.all_to_all_uneven(
        torch.tensor(counts, dtype=torch.int64), per_q, g, control=True)
    recs = (torch.cat(pieces) if pieces else
            torch.zeros((0, RECORD_WORDS), dtype=torch.int32, device=home))
    del pieces
    if home.type == "cuda":
        torch.cuda.synchronize(home)
    t0 = time.perf_counter()
    got, _ = distributed.all_to_all_uneven(recs, splits, g)
    if home.type == "cuda":
        torch.cuda.synchronize(home)
    total = distributed.all_reduce_sum(
        torch.tensor([recs.shape[0]], dtype=torch.int64), g, control=True)
    exchange_stats.update(
        bytes=int(total) * RECORD_WORDS * 4,
        rank_bytes=recs.shape[0] * RECORD_WORDS * 4,
        sent_off_rank=(recs.shape[0] - splits[g.ranks.index(me)])
        * RECORD_WORDS * 4,
        seconds=time.perf_counter() - t0)
    del recs
    # what came from each rank p: for each of my owners, each of p's
    # sources, in that order
    got_n = got_n.tolist()
    my_owners = [o for o in range(ndp) if owner_rank[o] == me]
    src_of = {p: [s for s in range(ndp) if mesh.ranks[s][0] == p]
              for p in g.ranks}
    parts = {o: [] for o in my_owners}
    a = c = 0
    for p in g.ranks:
        for o in my_owners:
            for _s in src_of[p]:
                n = got_n[c]
                c += 1
                parts[o].append(got[a:a + n])
                a += n
    return {o: _unpack_records(torch.cat(parts.pop(o)).to(
        mesh.devices[o][0])) for o in my_owners}


def _route_and_select(mesh, windows: dict, n_seqs: int, cap,
                      threshold: float, keep=None) -> tuple[list, list]:
    """Route this process's sources' windows ({source: windows}),
    exchange, select on each owner of this process.  Empties windows as
    it goes: each source's windows are freed once they are in its
    buckets.  -> (words, flags), per owner, None on another process's."""
    cells = dp_cells(mesh)
    ndp = len(cells)
    buckets = {}
    for s in sorted(windows):
        buckets[s] = route(windows[s], ndp, cap,
                           None if keep is None else keep[s])
        windows[s] = None
    received = exchange(mesh, buckets)
    del buckets
    words, flags = [None] * ndp, [None] * ndp
    for o in sorted(received):
        # the sorts and kernel 7 on what the owner received
        k1s, plen_s, seq_s, k2s = build_select.sort_windows(*received[o])
        received[o] = None
        words[o], flags[o] = build_select.build_select_runs(
            k1s, plen_s, k2s, seq_s, n_seqs, threshold)
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
    windows, keep = {}, {}
    for s, cell in enumerate(cells):
        if not mesh.is_local(s, 0):
            continue
        sl = slice(s * n_local, (s + 1) * n_local)
        h = np.asarray(hi[sl], np.uint32)
        valid = h != SENTINEL
        put = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(np.asarray(a)[sl][valid])
            .astype(np.int64)).to(cell)
        kmer = (put(hi) << 24) | put(lo)
        f = put(func)
        windows[s] = (build_extract.window_keys(kmer, f),
                      build_extract.window_keys(kmer, put(off)),
                      put(plen).to(torch.int32), put(seq).to(torch.int32))
        keep[s] = f >= 0
    words, flags = _route_and_select(mesh, windows, sids.shape[0],
                                     bucket_cap, threshold, keep)
    return ShardedSelection(words, flags, sids, mesh)


def build_step_from_seqs_arrays(mesh, packed, starts, fidxs, plens, sids,
                                threshold: float = 0.8,
                                bucket_cap: int | None = None
                                ) -> ShardedSelection:
    """The sharded selection from pack_corpus_sharded's stacked arrays:
    packed (ndp, Rl*16), starts, fidxs, plens, sids (ndp, Bg).  Kernel 6
    per shard on its cell (this process's shards), then the routing, the
    exchange and kernel 7 per owner.  The global sequence index of shard
    s's b-th entry is s * Bg + b."""
    cells = dp_cells(mesh)
    Bg = starts.shape[1]
    windows = {s: extract_shard(*upload_shard(cell, packed[s], starts[s],
                                              fidxs[s], plens[s]), s * Bg)
               for s, cell in enumerate(cells) if mesh.is_local(s, 0)}
    words, flags = _route_and_select(mesh, windows, len(cells) * Bg,
                                     bucket_cap, threshold)
    return ShardedSelection(words, flags, np.asarray(sids).reshape(-1),
                            mesh)


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
    return w if len(words) == 1 else sort_words(w)


def sort_words(w: torch.Tensor) -> torch.Tensor:
    """Kept words in ascending k-mer order."""
    u = w[:, :2].to(torch.int64) & 0xFFFF_FFFF
    return w[torch.sort((u[:, 0] << 16) | (u[:, 1] >> 16)).indices]


def _local(xs: list) -> list:
    return [x for x in xs if x is not None]


def finalize_sharded(outputs: ShardedSelection) -> dict:
    """The kept arrays (hi, lo, avg_from_end, function_index, mean,
    median, var), sorted by k-mer: the owners' words merged on the first
    cell, fetched once and unpacked on the host.  On a mesh that spans
    processes each rank merges its owners' words, the pieces reach every
    rank (fetch_global) and are merged again there."""
    from ..models.signature_builder import kept_from_words

    mine = _local(outputs.words)
    mesh = outputs.mesh
    if mesh is not None and mesh.spans_processes:
        dev = mesh.home
        local = (merge_words(mine, dev) if mine else
                 torch.zeros((0, 4), dtype=torch.int32, device=dev))
        every = distributed.fetch_global(local, mesh.all_group())
        words = sort_words(torch.from_numpy(every).to(dev)).cpu().numpy()
    else:
        words = merge_words(mine, mine[0].device).cpu().numpy()
    kept = kept_from_words(words)
    return {f.name: getattr(kept, f.name) for f in dataclasses.fields(kept)}


def kept_sids(outputs: ShardedSelection) -> np.ndarray:
    """The ids of the sequences with an entry in a kept group on any
    owner, in sequence-index order (on a mesh that spans processes, the
    ranks' flags OR-ed after a fetch_global)."""
    mine = _local(outputs.flags)
    mesh = outputs.mesh
    n = outputs.sids.shape[0]
    dev = mine[0].device if mine else mesh.home
    any_kept = torch.zeros(n, dtype=torch.bool, device=dev)
    for f in mine:
        any_kept |= f.to(dev).bool()
    if mesh is not None and mesh.spans_processes:
        every = distributed.fetch_global(
            any_kept.to(torch.uint8) if mine else any_kept[:0].to(
                torch.uint8), mesh.all_group())
        return outputs.sids[every.reshape(-1, n).any(axis=0)]
    return outputs.sids[any_kept.cpu().numpy()]
