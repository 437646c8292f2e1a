"""Multi-device function caller: dp-split queries x tp-split table.

The call step (transfer rows -> pack -> table probe -> automaton) runs
over a (dp, tp) mesh (parallel/mesh.py):

- query rounds are split by row across dp: each dp row of the mesh takes
  its own rows end to end (the automaton is per sequence, so no state
  crosses rows);
- the table is split across tp by key owner; every device of a dp row
  packs the row's windows and probes its own shard with the shard's own
  salt (kernel 1, then kernel 2 on a wide shard or kernel 8 on a cuckoo
  one), and the row's tp results are combined on its first device, where
  the automaton (kernel 3) runs: exact, since at most one shard holds a
  key and the probes write zeros for a miss.  Both production layouts
  shard (ShardedWideTable / ShardedBucketTable below);
- one device->host copy per dp row and round, then FunctionCaller's host
  finalize.

On a mesh that spans processes (parallel/distributed.py) every rank passes
the same batch, places (from_table) and probes only its own cells' shards, and the rows
that span ranks sum their int32 views over the row's process group
(combine_row); the automaton runs on each row's first cell, and the rows'
packed blocks are all-gathered at the end of the dispatch, so every rank's
collect_batch is a local read, as the JAX program's scatter + psum leaves
its result replicated.

This is the in-process replacement for the reference's "run many binaries
on disjoint files" scaling (SURVEY §2.5).  Each shard is a table of the
single-device layouts (WideKmerTable, BucketKmerTable), so every probe is
a kernel the single-device path runs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import CallConfig, DeviceConfig, TableConfig
from ..io import fasta as fasta_io
from ..models.function_caller import FunctionCaller, gather_probe
from ..ops import hashing, kmer_pack, probe
from ..table import wide_table as wt
from ..table.bucket_table import EMPTY, BucketKmerTable
from ..table.wide_table import WideKmerTable
from . import distributed, mesh as mesh_mod
from .sharded_table import combine_row, owner_of, share_rows, split_rows


def _occupied_slots(packed, slots: int) -> int:
    return int(np.count_nonzero(packed[:, :slots] != EMPTY))


def _agree_max(g, x: int) -> int:
    """The largest of the group's ranks' x: the common size of shards
    placed on different processes (x itself when g is None)."""
    return int(x) if g is None else max(distributed.gather_objects(int(x),
                                                                   g))


class ShardedBucketTable:
    """Per-shard BucketKmerTables stacked (tp, n_buckets, 3*slots).

    Each shard carries its own cuckoo salt (builds converge
    independently).  placed: the shards the arrays hold, in order (every
    shard, unless from_table was asked for some)."""

    def __init__(self, packed, salts, n_items: int, aux=None, placed=None):
        self.packed = packed  # (placed, nb, 3*slots)
        self.salts = salts    # (placed,) uint32
        self.n_items = n_items
        self.aux = aux        # (placed, nb, 3*slots) value words
        self.placed = (tuple(range(packed.shape[0])) if placed is None
                       else tuple(placed))

    @property
    def n_shards(self):
        return int(self.packed.shape[0])

    @property
    def n_buckets(self):
        return int(self.packed.shape[1])

    @staticmethod
    def from_table(table: BucketKmerTable, n_shards: int, only=None,
                   g=None) -> "ShardedBucketTable":
        """only: the shards to place (default every one); g: the group of
        the ranks that place the others, with whom the bucket count is
        agreed (every shard has the same)."""
        assert n_shards & (n_shards - 1) == 0
        hi, lo, v0, v1, v2 = table.occupied()
        if n_shards == 1:
            return ShardedBucketTable(
                table.packed[None],
                np.asarray([table.salt], dtype=np.uint32), table.n_items,
                aux=table.aux[None])
        owner = owner_of(hi, lo, n_shards)
        placed = range(n_shards) if only is None else sorted(only)
        # two-pass sizing: build every shard once at the largest shard's
        # bucket count, then rebuild only the shards that came out smaller
        # at the common (max) count, repeated until all agree (a
        # constrained rebuild can outgrow it; each pass raises the count)
        slots = TableConfig().slots
        counts = np.bincount(owner, minlength=n_shards)
        nb0 = max(TableConfig().min_size // slots,
                  hashing.next_pow2(-(-int(counts.max()) // 3)))

        def build(s, nb):
            m = owner == s
            return BucketKmerTable.build(hi[m], lo[m], v0[m], v1[m], v2[m],
                                         TableConfig(min_size=nb * slots))

        parts = {s: build(s, nb0) for s in placed}
        nb = _agree_max(g, max(t.n_buckets for t in parts.values()))
        while True:
            # a rebuild at nb has at least nb buckets: the shards agree
            # when the largest is nb
            parts = {s: t if t.n_buckets == nb else build(s, nb)
                     for s, t in parts.items()}
            top = _agree_max(g, max(t.n_buckets for t in parts.values()))
            if top == nb:
                break
            nb = top
        return ShardedBucketTable(
            np.stack([t.packed for t in parts.values()]),
            np.asarray([t.salt for t in parts.values()], dtype=np.uint32),
            int(hi.shape[0]), aux=np.stack([t.aux for t in parts.values()]),
            placed=list(parts))

    def shard(self, s: int) -> BucketKmerTable:
        """Shard s as a table of the single-device layout."""
        i = self.placed.index(s)
        return BucketKmerTable(
            self.packed[i], self.aux[i], int(self.salts[i]),
            _occupied_slots(self.packed[i], self.packed.shape[2] // 3))


class ShardedWideTable:
    """Per-shard WideKmerTables stacked (production layout).

    Shards share bits, ov_bits and slot widths so the arrays stack; salts
    vary per shard.  The overflow stores take one common (ov_bits,
    largest occupancy) shape.  placed: the shards the arrays hold, in
    order (every shard, unless from_table was asked for some)."""

    def __init__(self, packed, ov_packed, salts, ov_salts,
                 bits: int, ov_bits: int, n_items: int, ov_any: bool,
                 aux=None, ov_aux=None, placed=None):
        self.packed = packed        # (placed, nb, 2*S)
        self.ov_packed = ov_packed  # (placed, nbo, 2*So)
        self.salts = salts          # (placed,) uint32
        self.ov_salts = ov_salts    # (placed,) uint32
        self.bits = bits
        self.ov_bits = ov_bits
        self.n_items = n_items
        self.ov_any = ov_any
        self.aux = aux              # (placed, nb, 3*S) value words
        self.ov_aux = ov_aux        # (placed, nbo, 3*So)
        self.placed = (tuple(range(packed.shape[0])) if placed is None
                       else tuple(placed))

    @property
    def n_shards(self):
        return int(self.packed.shape[0])

    @staticmethod
    def from_table(table: WideKmerTable, n_shards: int, only=None,
                   g=None) -> "ShardedWideTable":
        """only: the shards to place (default every one); g: the group of
        the ranks that place the others.  The main geometry follows the
        global counts, which every rank has; the overflow leaves' (the
        largest leftover, the largest leaf bucket) are agreed over g, so
        every shard has the same shape wherever it was placed."""
        assert n_shards & (n_shards - 1) == 0
        if n_shards == 1:
            return ShardedWideTable(
                table.packed[None], table.ov_packed[None],
                np.asarray([table.salt], np.uint32),
                np.asarray([table.ov_salt], np.uint32),
                table.bits, table.ov_bits, table.n_items,
                table.ov_items > 0,
                aux=table.aux[None], ov_aux=table.ov_aux[None])
        hi, lo, v0, v1, v2 = table.occupied()
        owner = owner_of(hi, lo, n_shards)
        counts = np.bincount(owner, minlength=n_shards)
        placed = list(range(n_shards) if only is None else sorted(only))
        cfg = wt.WideTableConfig()
        S_def = cfg.slots
        want = int(int(counts.max()) / (S_def * cfg.main_load)) + 1
        bits_def = max(cfg.min_bits,
                       hashing.next_pow2(want).bit_length() - 1)
        # per-shard sub-cliff sizing, WideKmerTable.build's rule (with its
        # leaf acceptance check below)
        sub = cfg.sub_cliff_bytes
        S, bits = S_def, bits_def
        chose_sub = False
        if sub and (1 << bits_def) * 8 * S_def > sub:
            S_sub = max(S_def, 4)
            bits_cap = max(cfg.min_bits,
                           (sub // (8 * S_sub)).bit_length() - 1)
            if int(counts.max()) <= ((1 << bits_cap) * S_sub
                                     * cfg.sub_cliff_max_load):
                S, bits, chose_sub = S_sub, bits_cap, True

        def build_at(S, bits):
            mains, main_auxes, leftovers = [], [], []
            for s in placed:
                m = owner == s
                packed_s, aux_s, lx = wt._place_tagged(
                    hi[m], lo[m], v0[m], v1[m], v2[m], bits,
                    wt._SALT_BASE, S)
                mains.append(packed_s)
                main_auxes.append(aux_s)
                leftovers.append((hi[m][lx], lo[m][lx], v0[m][lx],
                                  v1[m][lx], v2[m][lx]))
            n = len(placed)
            salts = np.full(n, wt._SALT_BASE, dtype=np.uint32)
            nmax = _agree_max(g, max(lf[0].shape[0] for lf in leftovers))
            if not nmax:
                return ShardedWideTable(
                    np.stack(mains),
                    np.stack([np.full((1, 2), wt.EMPTY, np.uint32)] * n),
                    salts, np.full(n, wt._SALT_BASE, np.uint32),
                    bits, 17, int(hi.shape[0]), False,
                    aux=np.stack(main_auxes),
                    ov_aux=np.stack([np.zeros((1, 3), np.uint32)] * n),
                    placed=placed)
            # >= 17: wide_bucket_tag's tag/sentinel exactness bound (the
            # JAX package widens ov_bits when leaf_salt returns None,
            # which it never does)
            ov_bits = max(17, int(np.ceil(np.log2(
                max(nmax / wt._OV_LAMBDA, 1)))))
            return ShardedWideTable._with_leaves(
                mains, main_auxes, salts, leftovers, bits, ov_bits,
                int(hi.shape[0]), placed, g)

        t = build_at(S, bits)
        if chose_sub and t.ov_packed[0].nbytes > sub:
            # the shrunken main fed an oversized leaf: default sizing
            t = build_at(S_def, bits_def)
        return t

    @staticmethod
    def _with_leaves(mains, main_auxes, salts, leftovers, bits, ov_bits,
                     n_items, placed, g):
        chosen = [wt.leaf_salt(lf[0], lf[1], ov_bits)
                  if lf[0].shape[0] else (wt._SALT_BASE, 1)
                  for lf in leftovers]
        S_ov = max(1, _agree_max(g, max(mx for _, mx in chosen)))
        ovs, ov_auxes = [], []
        for lf, (salt_s, _mx) in zip(leftovers, chosen):
            p, a, rest = wt._place_tagged(*lf, ov_bits, salt_s, S_ov)
            assert rest.shape[0] == 0
            ovs.append(p)
            ov_auxes.append(a)
        return ShardedWideTable(
            np.stack(mains), np.stack(ovs), salts,
            np.asarray([s for s, _ in chosen], dtype=np.uint32),
            bits, ov_bits, n_items, True, aux=np.stack(main_auxes),
            ov_aux=np.stack(ov_auxes), placed=placed)

    def shard(self, s: int) -> WideKmerTable:
        """Shard s as a table of the single-device layout (its leaf probed
        only when it holds keys)."""
        i = self.placed.index(s)
        ov_items = (_occupied_slots(self.ov_packed[i],
                                    self.ov_packed.shape[2] // 2)
                    if self.ov_any else 0)
        return WideKmerTable(
            self.packed[i], self.aux[i], self.ov_packed[i], self.ov_aux[i],
            int(self.salts[i]), self.bits, int(self.ov_salts[i]),
            self.ov_bits,
            _occupied_slots(self.packed[i], self.packed.shape[2] // 2)
            + ov_items, ov_items)


class ParallelFunctionCaller(FunctionCaller):
    """FunctionCaller whose device step runs over a (dp, tp) mesh."""

    def __init__(self, table, function_index,
                 config: CallConfig = CallConfig(),
                 device_config: DeviceConfig = DeviceConfig(),
                 mesh=None):
        mesh = mesh if mesh is not None else mesh_mod.make_mesh()
        super().__init__(table, function_index, config, device_config,
                         device=mesh.home)
        self.mesh = mesh
        self.ndp = mesh_mod.dp_size(mesh)
        self.ntp = mesh_mod.tp_size(mesh)
        # this process's shards only: those of its cells' tp columns
        sharded = (ShardedWideTable if isinstance(table, WideKmerTable)
                   else ShardedBucketTable)
        self.stable = sharded.from_table(
            table, self.ntp, {t for _d, t, _dev in mesh.local_cells()},
            mesh.all_group())
        self.shards = [self.stable.shard(t) if t in self.stable.placed
                       else None for t in range(self.ntp)]
        # each cell's shard words, uploaded at first use (cell_tables)
        self._cells = {}

    def cell_tables(self, kind: str = "probe") -> list:
        """cells[d][t]: shard t's words on device (d, t), each cell its
        own tensors, uploaded once per caller (the sharded table is
        immutable; /add builds a new caller); None on another process's
        cell.  kind: "probe" (the layout's to_device), "aux" (the probe
        words, then aux_to_device) or "distance" (a wide shard's distance
        rows)."""
        cells = self._cells.get(kind)
        if cells is None:
            # the aux words join the probe words, which come up first
            base = self.cell_tables() if kind == "aux" else None
            # serialized: the service's threads must not upload twice
            with self._cache_lock:
                cells = self._cells.get(kind)
                if cells is None:
                    cells = self._upload(kind, base)
                    self._cells[kind] = cells
        return cells

    def _upload(self, kind: str, base) -> list:
        up = {"probe": lambda s, dev: s.to_device(dev),
              "aux": lambda s, dev: s.aux_to_device(dev),
              "distance": lambda s, dev: s.distance_rows_to_device(dev)}[kind]
        return [[(base[d][t] if base else ()) + up(shard, dev)
                 if self.mesh.is_local(d, t) else None
                 for t, (dev, shard) in enumerate(zip(row, self.shards))]
                for d, row in enumerate(self.mesh.devices)]

    # -- the call path -------------------------------------------------------

    def call_batch(self, batch: fasta_io.SequenceBatch,
                   keep_hits: bool = False):
        """The call over the mesh: dispatch_batch (every launch), then
        collect_batch (the device->host copies and host scoring)."""
        return self.collect_batch(self.dispatch_batch(batch, keep_hits))

    def dispatch_batch(self, batch: fasta_io.SequenceBatch,
                       keep_hits: bool = False):
        """Enqueue every round of a call; returns a handle for
        collect_batch.  keep_hits takes FunctionCaller's exact route,
        whose hit gathering runs over the mesh (_gather_words)."""
        if keep_hits:
            return ("local", super().call_batch(batch, keep_hits=True))
        rows = self.device_config.call_batch
        per_round = rows * self.ndp
        n = len(batch)
        # length-sorted rounds, as in FunctionCaller.call_batch: each dp
        # row's (L, W) follows its own longest sequence
        lens_all = batch.lengths
        order = None
        if (self.device_config.sort_by_length and n > 1
                and not self.config.order_constraint
                and np.any(lens_all[:-1] > lens_all[1:])):
            order = np.argsort(lens_all, kind="stable")
            batch = self._permute_batch(batch, order)
        pending = []
        for s in range(0, n, per_round):
            e = min(s + per_round, n)
            for d in range(self.ndp):
                ds = min(s + d * rows, e)
                de = min(ds + rows, e)
                if ds == de:
                    continue
                sub = fasta_io.SequenceBatch(
                    codes=batch.codes[batch.offsets[ds]:batch.offsets[de]],
                    offsets=batch.offsets[ds:de + 1] - batch.offsets[ds],
                    ids=batch.ids[ds:de],
                    deflines=batch.deflines[ds:de],
                )
                pending.append((sub, d, self._dispatch_row(d, sub)))
        if self.mesh.spans_processes:
            # the rows' blocks on every rank: collect_batch reads locally
            blocks = distributed.share({
                i: out for i, (_s, _d, out) in enumerate(pending)
                if out is not None}, self.mesh.all_group(), self.device)
            pending = [(sub, d, blocks[i])
                       for i, (sub, d, _o) in enumerate(pending)]
        return ("mesh", order, pending)

    def _dispatch_row(self, d: int, sub: fasta_io.SequenceBatch):
        """One dp row's share of a round: pack and probe on each of the
        row's devices of this process, combine (combine_row), automaton on
        the row's first device -> the (rows, 13) packed block there, or
        None on a process that does not own that device."""
        mine = self.mesh.local_columns(d)
        if not mine:
            return None
        *host, L, W = self._chunk_rows(sub)
        cells = self.cell_tables()[d]
        parts = []
        home_lengths = None
        for t in mine:
            dev = self.mesh.devices[d][t]
            t_rows = tuple(self._to_device(a, dev) for a in host)
            if home_lengths is None:
                home_lengths = t_rows[2]
            hi, lo, valid = kmer_pack.pack_call_windows_rows16(*t_rows, L, W)
            fn, geometry = probe.table_probe(self.shards[t])
            parts.append(fn(hi, lo, valid, *cells[t], **geometry,
                            ignore_function=self._ignore_function()))
        found, fm = combine_row(self.mesh, d, parts,
                                self.mesh.devices[d][mine[0]])
        if mine[0] != 0:
            return None
        return self._automaton(found, fm, home_lengths)

    def collect_batch(self, handle):
        """Read a dispatched call's blocks and run the host scoring, in
        input order."""
        if handle[0] == "local":
            return handle[1]
        _tag, order, pending = handle
        results = []
        for sub, _d, out in pending:
            results.extend(self._finalize_device(sub, out))
        if order is not None:
            results = self._restore_order(results, order)
        return results

    # -- hit gathering (/lookup, --debug-hits) and the distance mask ---------

    def _row_blocks(self, codes: np.ndarray, offsets: np.ndarray,
                    rows: int):
        """(d, a, b, codes, offsets) of each dp row's non-empty share of
        concatenated rows."""
        for d, (a, b) in enumerate(split_rows(rows, self.ndp)):
            if a < b:
                yield (d, a, b, codes[offsets[a]:offsets[b]],
                       offsets[a:b + 1] - offsets[a])

    def _gather_words(self, codes: np.ndarray, offsets: np.ndarray,
                      rows: int, L: int, need_aux: bool) -> list:
        """The hit probe over the mesh: each dp row's share probed against
        every shard on the row's devices (the single-device probes:
        probe_wide_aux on wide shards with aux, else the pack and the
        shard's probe), combined on the row's first device (combine_row),
        the rows on every rank (share_rows) and concatenated on the
        host."""
        cells = self.cell_tables("aux" if need_aux else "probe")
        blocks = {}
        for d, a, b, c, o in self._row_blocks(codes, offsets, rows):
            mine = self.mesh.local_columns(d)
            if not mine:
                continue
            parts = [gather_probe(self.shards[t], self.transfer_rows(
                c, o, b - a, L, self.mesh.devices[d][t]), L, cells[d][t],
                need_aux) for t in mine]
            out = combine_row(self.mesh, d, parts,
                              self.mesh.devices[d][mine[0]])
            blocks[d] = torch.stack([x.to(torch.int32) for x in out])
        blocks = share_rows(self.mesh, blocks, torch.device("cpu"))
        if not blocks:
            return super()._gather_words(codes, offsets, rows, L, need_aux)
        x = np.concatenate([blocks[d].cpu().numpy() for d in sorted(blocks)],
                           axis=1)
        return [x[0] != 0] + [x[k] for k in range(1, x.shape[0])]

    def gather_found_filtered(self, codes: np.ndarray, lengths: np.ndarray,
                              hypo_index: int, len_sigma_window: float,
                              zero_var_len_frac: float) -> np.ndarray:
        """The matrix-distance mask of (B, L) codes over the mesh (the
        mesh service's /matrix): the hypothetical and length filters run
        on the devices and only the mask comes back.  Wide shards run
        probe_wide_distance on their distance rows, other layouts the
        pack, the aux probe and probe.distance_filter; each dp row's tp
        masks are combined (combine_row) and the rows shared with every
        rank (share_rows).  -> (B, L) bool."""
        B, L = codes.shape
        lengths = np.minimum(np.asarray(lengths, np.int64), L)
        offsets = np.zeros(B + 1, np.int64)
        np.cumsum(lengths, out=offsets[1:])
        flat = codes[np.arange(L)[None, :] < lengths[:, None]]
        filters = dict(hypo=hypo_index,
                       len_sigma_window=float(len_sigma_window),
                       zero_var_len_frac=float(zero_var_len_frac))
        wide = isinstance(self.table, WideKmerTable)
        cells = self.cell_tables("distance" if wide else "aux")
        k = self.config.k
        mask = np.zeros((B, L), dtype=bool)
        masks, spans = {}, {}
        for d, a, b, c, o in self._row_blocks(flat, offsets, B):
            nat = int(lengths[a:b].max())
            W = min(L, max(16, -(-(max(nat, k) - k + 1) // 16) * 16))
            spans[d] = (a, b, W)
            mine = self.mesh.local_columns(d)
            parts = []
            for t in mine:
                dev, shard = self.mesh.devices[d][t], self.shards[t]
                t_rows = self.transfer_rows(c, o, b - a, L, dev)
                geometry = probe.table_probe(shard)[1]
                if wide:
                    m = probe.probe_wide_distance(
                        *t_rows, L, W, *cells[d][t], **geometry,
                        slots=shard.slots, ov_slots=shard.ov_slots,
                        **filters)
                else:
                    hi, lo, valid = kmer_pack.pack_call_windows_rows16(
                        *t_rows, L, W)
                    fn = probe.table_probe(shard, with_aux=True)[0]
                    found, fm, _r0, _r1, r2 = fn(hi, lo, valid,
                                                 *cells[d][t], **geometry)
                    m = found & probe.distance_filter(fm, r2, t_rows[2],
                                                      **filters)
                parts.append((m,))
            if mine:
                masks[d] = combine_row(self.mesh, d, parts,
                                       self.mesh.devices[d][mine[0]])[0]
        for d, m in share_rows(self.mesh, masks, torch.device("cpu")).items():
            a, b, W = spans[d]
            mask[a:b, :W] = m.cpu().numpy()
        return mask
