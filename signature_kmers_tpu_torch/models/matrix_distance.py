"""Matrix distance: shared-signature-k-mer pair counts.

The reference builds k-mer -> {sequence ids} sets and increments a nested
map for every id pair per k-mer (ref: matrix_distance.h:45-148,
kmers-matrix-distance.cc:118-196).  Here the hits are gathered on the
device, filtered there and only the (B, W) found mask comes back: on a
wide table one probe_wide_distance launch per chunk (it reads the
transfer rows and one distance row per window, built from the table at
first use); on a cuckoo or CMPH table the pack, the layout's aux probe
(probe_bucket_aux, probe_cmph_aux) and the filters as torch operations
on the device (ops/probe.distance_filter).  The host
rebuilds the hit keys from the codes, keeps each (k-mer, sequence) pair
once, and the (distinct k-mer x sequence) incidence matrix A is densified
on the device block by block, accumulating C = sum_b A_b^T A_b with
float32 products.

On a mesh (compute(..., mesh=)) the incidence blocks are split over every
device of the mesh, each accumulating its own partial C, and the partials
are summed on the mesh's first device: the JAX package's psum over the
(dp, tp) grid.  On a mesh that spans processes each rank counts its own
cells' blocks, and the partials are summed over every rank
(all_reduce_sum), so every rank gets the same matrix.  With
``mesh_caller`` set (the mesh service), the hits are gathered against
the tp-split table by that ParallelFunctionCaller
(gather_found_filtered) instead of this object's own caller.

Filter semantics match the reference:
- ignore_hypothetical is forced on (matrix_distance.h:88);
- a hit is dropped when the sequence length lies outside mean +/-
  2*stddev, stddev = sqrt(var), or 0.1*length when var == 0
  (matrix_distance.h:63-78);
- each (k-mer, sequence) pair counts once (set semantics).

Counts are exact: every product sums 0/1 entries into float32, exact below
2^24, and a pair's count is bounded by the shorter protein's window count.
TF32 products would not be exact, so they are turned off around each
product.
"""

from __future__ import annotations

import contextlib
import sys
import threading

import numpy as np
import torch

from ..core.config import CallConfig, DeviceConfig, DistanceConfig
from ..golden.distance import DistanceResult
from ..io import fasta as fasta_io
from ..ops import kmer_pack, probe
from ..parallel import distributed
from ..table import WideKmerTable
from . import function_caller as function_caller_mod
from .function_caller import FunctionCaller

DENSE_BLOCK = 8192  # k-mer rows per incidence block on the dense path
TILE_KBLOCK = 4096  # k-mer rows per incidence block on the tiled path


# the TF32 switch is process-wide: threads that count pairs at once (the
# service's /matrix) take turns, so none restores it under another
_FLOAT32_LOCK = threading.Lock()


@contextlib.contextmanager
def _full_float32():
    """float32 matrix products without TF32, the caller's setting
    restored afterwards."""
    with _FLOAT32_LOCK:
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before


def _incidence(A: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor):
    """A := the 0/1 matrix with ones at (rows, cols) (pairs distinct)."""
    A.zero_()
    A.index_put_((rows, cols), torch.ones_like(rows, dtype=A.dtype),
                 accumulate=True)
    return A


def _nonzero_pairs(C: torch.Tensor, i0: int, j0: int, upper: bool):
    """(i0 + i, j0 + j, count) of C's nonzero cells (above the diagonal
    only when upper), in row-major order."""
    if upper:
        C = torch.triu(C, diagonal=1)
    nz = torch.nonzero(C)
    counts = C[nz[:, 0], nz[:, 1]].to(torch.int64).cpu().tolist()
    nz = nz.cpu()
    return list(zip((nz[:, 0] + i0).tolist(), (nz[:, 1] + j0).tolist(),
                    counts))


class MatrixDistance:
    """All-vs-all shared-signature counts against a table of any layout
    that ops/probe.table_probe serves (wide, cuckoo, reference CMPH)."""

    def __init__(self, table, function_index: list[str],
                 config: DistanceConfig = DistanceConfig(),
                 device_config: DeviceConfig = DeviceConfig(),
                 device="cuda"):
        self.table = table
        self.config = config
        self.device_config = device_config
        # distance always ignores hypothetical-protein k-mers
        self.caller = FunctionCaller(
            table, function_index, CallConfig(ignore_hypothetical=True),
            device_config, device=device)
        self.device = self.caller.device
        self.hypo_index = self.caller.hypo_index
        self._drows = None  # the distance rows, built at first use
        self._drows_lock = threading.Lock()
        # a ParallelFunctionCaller that gathers the hits over its mesh
        # (the mesh service sets it), or None
        self.mesh_caller = None

    def device_tables(self) -> tuple:
        """(drows, ov_drows): a wide table's distance rows on the device
        (WideKmerTable.distance_rows_to_device), built at first use; the
        distance path on a wide table holds no other table rows."""
        if self._drows is None:
            with self._drows_lock:  # the service computes from threads
                if self._drows is None:
                    self._drows = self.table.distance_rows_to_device(
                        self.device)
        return self._drows

    def filter_args(self) -> dict:
        """The filter's arguments (ops/probe.distance_filter)."""
        return dict(hypo=self.hypo_index,
                    len_sigma_window=self.config.len_sigma_window,
                    zero_var_len_frac=self.config.zero_var_len_frac)

    def distance_geometry(self) -> dict:
        """A wide table's geometry and the filter as probe_wide_distance
        takes them."""
        t = self.table
        return dict(self.caller.probe_geometry(), slots=t.slots,
                    ov_slots=t.ov_slots, **self.filter_args())

    def compute(self, batches: list[fasta_io.SequenceBatch], mesh=None
                ) -> DistanceResult:
        """All-vs-all shared-signature-k-mer counts over the batches'
        sequences (ids interned in order of first appearance).  With
        ``mesh`` the pair counting is split over every mesh device; counts
        are exact at any device count (integer-valued float32 partial
        sums)."""
        ids: list[str] = []
        id_to_idx: dict[str, int] = {}
        prot_sizes: dict[str, int] = {}
        kmer_keys: list[np.ndarray] = []
        kmer_seqs: list[np.ndarray] = []

        cfg = self.device_config
        for batch in batches:
            n = len(batch)
            for s in range(0, n, cfg.call_batch):
                e = min(s + cfg.call_batch, n)
                sub = fasta_io.SequenceBatch(
                    codes=batch.codes[batch.offsets[s]:batch.offsets[e]],
                    offsets=batch.offsets[s:e + 1] - batch.offsets[s],
                    ids=batch.ids[s:e],
                    deflines=batch.deflines[s:e],
                )
                found = self._gather(sub)
                row_idx = np.empty(len(sub), dtype=np.int64)
                for i, sid in enumerate(sub.ids):
                    if sid not in id_to_idx:
                        id_to_idx[sid] = len(ids)
                        ids.append(sid)
                    row_idx[i] = id_to_idx[sid]
                    prot_sizes[sid] = int(sub.lengths[i])
                b, l = np.nonzero(found)
                if b.size:
                    # the hit windows' keys, rebuilt from the codes (the
                    # device returns only the mask)
                    pos = sub.offsets[b].astype(np.int64) + l
                    c = [sub.codes[pos + j].astype(np.uint64)
                         for j in range(8)]
                    hi = (c[0] << 18) | (c[1] << 12) | (c[2] << 6) | c[3]
                    lo = (c[4] << 18) | (c[5] << 12) | (c[6] << 6) | c[7]
                    kmer_keys.append((hi << np.uint64(24)) | lo)
                    kmer_seqs.append(row_idx[b])

        if not kmer_keys:
            return DistanceResult(ids=ids, prot_sizes=prot_sizes, pairs=[])

        keys = np.concatenate(kmer_keys)
        seqs = np.concatenate(kmer_seqs)
        # distinct (kmer, seq) pairs via lexsort
        order = np.lexsort((seqs, keys))
        keys = keys[order]
        seqs = seqs[order]
        first = np.ones(keys.size, dtype=bool)
        first[1:] = (keys[1:] != keys[:-1]) | (seqs[1:] != seqs[:-1])
        keys = keys[first]
        seqs = seqs[first]
        _, kmer_id = np.unique(keys, return_inverse=True)
        pairs = self._pairs(kmer_id, seqs, len(ids), mesh)
        return DistanceResult(ids=ids, prot_sizes=prot_sizes, pairs=pairs)

    def _pairs(self, kmer_id, seqs, n_seqs, mesh=None):
        """(i, j, count) triples with i < j, sorted.

        Up to config.dense_pair_limit sequences one dense (S, S)
        accumulator; past it (tile_size x tile_size) output tiles, so
        device memory stays bounded by the tile, not by S^2."""
        if n_seqs >= 8 and n_seqs > self.config.dense_pair_limit:
            return self._pairs_tiled(kmer_id, seqs, n_seqs, mesh)
        C = self._pair_counts(kmer_id, seqs, n_seqs, mesh)
        pairs = _nonzero_pairs(C, 0, 0, upper=True)
        pairs.sort()
        return pairs

    # -- internals ---------------------------------------------------------

    def _gather(self, sub: fasta_io.SequenceBatch) -> np.ndarray:
        """Device hit gathering with the distance filters applied on the
        device; only the (B, W) found mask returns.  W drops the padding
        windows past the sub-batch's longest sequence (the probe pays per
        window).  With mesh_caller the mask is its gather_found_filtered
        over the mesh, (B, L)."""
        if self.mesh_caller is not None:
            codes, lengths = function_caller_mod.pad_bucketed(sub, len(sub))
            return self.mesh_caller.gather_found_filtered(
                codes, lengths, self.hypo_index,
                self.config.len_sigma_window, self.config.zero_var_len_frac)
        k = self.config.k
        nat = int(sub.lengths.max()) if len(sub) else k
        L = function_caller_mod.bucket_length(sub)
        W = min(L, max(16, -(-(max(nat, k) - k + 1) // 16) * 16))
        t_rows = self.caller.transfer_rows(sub.codes, sub.offsets, len(sub),
                                           L)
        if isinstance(self.table, WideKmerTable):
            mask = probe.probe_wide_distance(
                *t_rows, L, W, *self.device_tables(),
                **self.distance_geometry())
        else:
            hi, lo, valid = kmer_pack.pack_call_windows_rows16(*t_rows, L, W)
            fn, geometry = probe.table_probe(self.table, with_aux=True)
            found, fm, _r0, _r1, r2 = fn(
                hi, lo, valid, *self.caller.device_tables(with_aux=True),
                **geometry)
            mask = found & probe.distance_filter(fm, r2, t_rows[2],
                                                 **self.filter_args())
        return mask.cpu().numpy()

    def _cells(self, mesh) -> list:
        """The cells that count pairs, as (device, is this process's):
        every cell of the mesh, or this object's device."""
        if mesh is None:
            return [(self.device, True)]
        return [(dev, mesh.is_local(d, t))
                for d, row in enumerate(mesh.devices)
                for t, dev in enumerate(row)]

    @staticmethod
    def _sum_ranks(C, mesh, shape):
        """Partial counts summed over every rank of a process-spanning
        mesh (C None: this process counted none), else C as it is."""
        g = mesh.all_group() if mesh is not None else None
        if g is None:
            return C
        if C is None:
            C = torch.zeros(shape, dtype=torch.float32, device=mesh.home)
        return distributed.all_reduce_sum(C, g)

    def _pair_counts(self, kmer_id: np.ndarray, seqs: np.ndarray,
                     n_seqs: int, mesh=None) -> torch.Tensor:
        """Blocked incidence product C = sum_b A_b^T A_b, (S, S), on the
        device from 8 sequences on, else on the host (symmetric; only the
        cells above the diagonal are read).  On a mesh each device takes
        a contiguous share of the blocks and accumulates its own partial
        C; the partials are summed on the first device."""
        n_kmers = int(kmer_id.max()) + 1 if kmer_id.size else 0
        if n_seqs == 0 or n_kmers == 0:
            return torch.zeros((0, 0), dtype=torch.int64)
        if mesh is not None and n_seqs < 8:
            # the JAX package's notice (its use_device is always set here)
            print("matrix-distance: --mesh ignored (host fallback path: "
                  f"use_device=True, n_seqs={n_seqs} < 8)", file=sys.stderr)
            mesh = None
        order = np.argsort(kmer_id, kind="stable")
        kk = kmer_id[order]
        ss = seqs[order]
        if n_seqs < 8:
            C = np.zeros((n_seqs, n_seqs), dtype=np.int64)
            starts = np.concatenate(
                [[0], np.nonzero(np.diff(kk))[0] + 1, [kk.size]])
            for a, b in zip(starts[:-1], starts[1:]):
                members = ss[a:b]
                C[np.ix_(members, members)] += 1
            np.fill_diagonal(C, 0)
            return torch.from_numpy(C)
        # the (kmer, seq) pairs are distinct, so each block's incidence is
        # an exact 0/1 matrix; each device's indices go up once, its
        # blocks are densified there
        bounds = np.searchsorted(
            kk, np.arange(0, n_kmers + DENSE_BLOCK, DENSE_BLOCK)).tolist()
        nb = len(bounds) - 1
        cells = self._cells(mesh)
        per = -(-nb // len(cells))
        C = None
        with _full_float32():
            for i, (dev, mine) in enumerate(cells):
                first, last = i * per, min((i + 1) * per, nb)
                if first >= last or not mine:
                    continue
                base = bounds[first]
                kk_t = torch.from_numpy(kk[base:bounds[last]]).to(dev)
                ss_t = torch.from_numpy(ss[base:bounds[last]]).to(dev)
                A = torch.empty((DENSE_BLOCK, n_seqs), dtype=torch.float32,
                                device=dev)
                part = torch.zeros((n_seqs, n_seqs), dtype=torch.float32,
                                   device=dev)
                for bi in range(first, last):
                    a, b = bounds[bi] - base, bounds[bi + 1] - base
                    _incidence(A, kk_t[a:b] - bi * DENSE_BLOCK, ss_t[a:b])
                    part.addmm_(A.t(), A)
                C = part if C is None else C.add_(part.to(C.device))
        return self._sum_ranks(C, mesh, (n_seqs, n_seqs))

    def _pairs_tiled(self, kmer_id: np.ndarray, seqs: np.ndarray,
                     n_seqs: int, mesh=None):
        """Tiled pair counting for large S: device memory is bounded by
        one (tile_size x tile_size) output tile; only the nonzero
        (i, j, count) triples of each upper-triangular tile reach the
        host (ref regime: matrix_distance.h:128-148 nested maps).  On a
        mesh each device takes a contiguous share of the k-mer blocks of
        every tile, and the tile's partials are summed on the first."""
        sblk = self.config.tile_size
        kblock = TILE_KBLOCK
        n_kmers = int(kmer_id.max()) + 1 if kmer_id.size else 0
        if n_kmers == 0:
            return []
        nsb = -(-n_seqs // sblk)
        nkb = -(-n_kmers // kblock)

        # per sequence block: its entries sorted by k-mer and the entry
        # range of each k-mer block
        sb = (seqs // sblk).astype(np.int64)
        order = np.lexsort((kmer_id, sb))
        kk = kmer_id[order]
        ss = seqs[order]
        blk_start = np.searchsorted(sb[order], np.arange(nsb + 1))
        host = []
        for j in range(nsb):
            a, b = int(blk_start[j]), int(blk_start[j + 1])
            kj = kk[a:b]
            host.append((kj, ss[a:b] - j * sblk,
                         np.searchsorted(kj, np.arange(nkb + 1)
                                         * kblock).tolist(),
                         min(sblk, n_seqs - j * sblk)))
        # per device: its k-mer blocks [lo, hi) and each sequence block's
        # entries of them, uploaded once
        cells = self._cells(mesh)
        per = -(-nkb // len(cells))
        shares = []
        for r, (dev, mine) in enumerate(cells):
            lo, hi = r * per, min((r + 1) * per, nkb)
            if lo < hi and mine:
                shares.append((dev, lo, hi, [
                    (torch.from_numpy(kj[c[lo]:c[hi]]).to(dev),
                     torch.from_numpy(sj[c[lo]:c[hi]]).to(dev))
                    for kj, sj, c, _ in host]))

        def incidence(A, share, j, bi):
            k_t, s_t = share[3][j]
            c = host[j][2]
            a, b = c[bi] - c[share[1]], c[bi + 1] - c[share[1]]
            return _incidence(A, k_t[a:b] - bi * kblock, s_t[a:b])

        pairs = []
        with _full_float32():
            for i in range(nsb):
                for j in range(i, nsb):
                    wi, wj = host[i][3], host[j][3]
                    C = None
                    for share in shares:
                        dev = share[0]
                        AI = torch.empty((kblock, wi), dtype=torch.float32,
                                         device=dev)
                        AJ = AI if i == j else torch.empty(
                            (kblock, wj), dtype=torch.float32, device=dev)
                        part = torch.zeros((wi, wj), dtype=torch.float32,
                                           device=dev)
                        for bi in range(share[1], share[2]):
                            # a k-mer block that either side misses adds 0
                            if (host[i][2][bi] == host[i][2][bi + 1]
                                    or host[j][2][bi] == host[j][2][bi + 1]):
                                continue
                            incidence(AI, share, i, bi)
                            if i != j:
                                incidence(AJ, share, j, bi)
                            part.addmm_(AI.t(), AJ)
                        C = part if C is None else C.add_(part.to(C.device))
                    C = self._sum_ranks(C, mesh, (wi, wj))
                    pairs.extend(_nonzero_pairs(C, i * sblk, j * sblk,
                                                upper=i == j))
        pairs.sort()
        return pairs
