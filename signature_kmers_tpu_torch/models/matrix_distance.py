"""Matrix distance: shared-signature-k-mer pair counts on one device.

The reference builds k-mer -> {sequence ids} sets and increments a nested
map for every id pair per k-mer (ref: matrix_distance.h:45-148,
kmers-matrix-distance.cc:118-196).  Here the hits are gathered on the
device, filtered there and only the (B, W) found mask comes back (one
probe_wide_distance launch per chunk: it reads the transfer rows and one
distance row per window, built from the table at first use); the host
rebuilds the hit keys from the codes, keeps each (k-mer, sequence) pair
once, and the (distinct k-mer x sequence) incidence matrix A is densified
on the device block by block, accumulating C = sum_b A_b^T A_b with
float32 products.

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

import numpy as np
import torch

from ..core.config import CallConfig, DeviceConfig, DistanceConfig
from ..golden.distance import DistanceResult
from ..io import fasta as fasta_io
from ..ops import probe
from . import function_caller as function_caller_mod
from .function_caller import FunctionCaller

DENSE_BLOCK = 8192  # k-mer rows per incidence block on the dense path
TILE_KBLOCK = 4096  # k-mer rows per incidence block on the tiled path


@contextlib.contextmanager
def _full_float32():
    """float32 matrix products without TF32, the caller's setting
    restored afterwards."""
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
    """All-vs-all shared-signature counts against a WideKmerTable."""

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

    def device_tables(self) -> tuple:
        """(drows, ov_drows): the table's distance rows on the device
        (WideKmerTable.distance_rows_to_device), built at first use; the
        distance path holds no other table rows."""
        if self._drows is None:
            self._drows = self.table.distance_rows_to_device(self.device)
        return self._drows

    def distance_geometry(self) -> dict:
        """The table geometry and the filter as probe_wide_distance takes
        them."""
        t = self.table
        return dict(self.caller.probe_geometry(), slots=t.slots,
                    ov_slots=t.ov_slots, hypo=self.hypo_index,
                    len_sigma_window=self.config.len_sigma_window,
                    zero_var_len_frac=self.config.zero_var_len_frac)

    def compute(self, batches: list[fasta_io.SequenceBatch]
                ) -> DistanceResult:
        """All-vs-all shared-signature-k-mer counts over the batches'
        sequences (ids interned in order of first appearance)."""
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
        pairs = self._pairs(kmer_id, seqs, len(ids))
        return DistanceResult(ids=ids, prot_sizes=prot_sizes, pairs=pairs)

    def _pairs(self, kmer_id, seqs, n_seqs):
        """(i, j, count) triples with i < j, sorted.

        Up to config.dense_pair_limit sequences one dense (S, S)
        accumulator; past it (tile_size x tile_size) output tiles, so
        device memory stays bounded by the tile, not by S^2."""
        if n_seqs >= 8 and n_seqs > self.config.dense_pair_limit:
            return self._pairs_tiled(kmer_id, seqs, n_seqs)
        C = self._pair_counts(kmer_id, seqs, n_seqs)
        pairs = _nonzero_pairs(C, 0, 0, upper=True)
        pairs.sort()
        return pairs

    # -- internals ---------------------------------------------------------

    def _gather(self, sub: fasta_io.SequenceBatch) -> np.ndarray:
        """Device hit gathering with the distance filters applied on the
        device; only the (B, W) found mask returns.  W drops the padding
        windows past the sub-batch's longest sequence (the probe pays per
        window)."""
        k = self.config.k
        nat = int(sub.lengths.max()) if len(sub) else k
        L = function_caller_mod.bucket_length(sub)
        W = min(L, max(16, -(-(max(nat, k) - k + 1) // 16) * 16))
        t_rows = self.caller.transfer_rows(sub.codes, sub.offsets, len(sub),
                                           L)
        mask = probe.probe_wide_distance(*t_rows, L, W, *self.device_tables(),
                                         **self.distance_geometry())
        return mask.cpu().numpy()

    def _pair_counts(self, kmer_id: np.ndarray, seqs: np.ndarray,
                     n_seqs: int) -> torch.Tensor:
        """Blocked incidence product C = sum_b A_b^T A_b, (S, S), on the
        device from 8 sequences on, else on the host (symmetric; only the
        cells above the diagonal are read)."""
        n_kmers = int(kmer_id.max()) + 1 if kmer_id.size else 0
        if n_seqs == 0 or n_kmers == 0:
            return torch.zeros((0, 0), dtype=torch.int64)
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
        # an exact 0/1 matrix; the indices go up once, the blocks are
        # densified on the device
        bounds = np.searchsorted(
            kk, np.arange(0, n_kmers + DENSE_BLOCK, DENSE_BLOCK)).tolist()
        dev = self.device
        kk_t = torch.from_numpy(kk).to(dev)
        ss_t = torch.from_numpy(ss).to(dev)
        A = torch.empty((DENSE_BLOCK, n_seqs), dtype=torch.float32,
                        device=dev)
        C = torch.zeros((n_seqs, n_seqs), dtype=torch.float32, device=dev)
        with _full_float32():
            for bi in range(len(bounds) - 1):
                a, b = bounds[bi], bounds[bi + 1]
                _incidence(A, kk_t[a:b] - bi * DENSE_BLOCK, ss_t[a:b])
                C.addmm_(A.t(), A)
        return C

    def _pairs_tiled(self, kmer_id: np.ndarray, seqs: np.ndarray,
                     n_seqs: int):
        """Tiled pair counting for large S: device memory is bounded by
        one (tile_size x tile_size) output tile; only the nonzero
        (i, j, count) triples of each upper-triangular tile reach the
        host (ref regime: matrix_distance.h:128-148 nested maps)."""
        sblk = self.config.tile_size
        kblock = TILE_KBLOCK
        n_kmers = int(kmer_id.max()) + 1 if kmer_id.size else 0
        if n_kmers == 0:
            return []
        nsb = -(-n_seqs // sblk)
        nkb = -(-n_kmers // kblock)

        # per sequence block: its entries sorted by k-mer, uploaded once,
        # and the entry range of each k-mer block
        sb = (seqs // sblk).astype(np.int64)
        order = np.lexsort((kmer_id, sb))
        kk = kmer_id[order]
        ss = seqs[order]
        blk_start = np.searchsorted(sb[order], np.arange(nsb + 1))
        dev = self.device
        blocks = []
        for j in range(nsb):
            a, b = int(blk_start[j]), int(blk_start[j + 1])
            kj = kk[a:b]
            cuts = np.searchsorted(kj, np.arange(nkb + 1) * kblock).tolist()
            blocks.append((torch.from_numpy(kj).to(dev),
                           torch.from_numpy(ss[a:b] - j * sblk).to(dev),
                           cuts, min(sblk, n_seqs - j * sblk)))

        def incidence(A, block, bi):
            k_t, s_t, cuts, _ = block
            a, b = cuts[bi], cuts[bi + 1]
            return _incidence(A, k_t[a:b] - bi * kblock, s_t[a:b])

        pairs = []
        with _full_float32():
            for i in range(nsb):
                for j in range(i, nsb):
                    wi, wj = blocks[i][3], blocks[j][3]
                    AI = torch.empty((kblock, wi), dtype=torch.float32,
                                     device=dev)
                    AJ = AI if i == j else torch.empty(
                        (kblock, wj), dtype=torch.float32, device=dev)
                    C = torch.zeros((wi, wj), dtype=torch.float32,
                                    device=dev)
                    for bi in range(nkb):
                        # a k-mer block that either side misses adds 0
                        if (blocks[i][2][bi] == blocks[i][2][bi + 1]
                                or blocks[j][2][bi] == blocks[j][2][bi + 1]):
                            continue
                        incidence(AI, blocks[i], bi)
                        if i != j:
                            incidence(AJ, blocks[j], bi)
                        C.addmm_(AI.t(), AJ)
                    pairs.extend(_nonzero_pairs(C, i * sblk, j * sblk,
                                                upper=i == j))
        pairs.sort()
        return pairs
