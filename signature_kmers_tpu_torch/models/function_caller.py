"""Production function caller: device hit gathering + call scoring.

Pipeline (ref architecture: call_functions.tcc:259-338):

  FASTA -> 16-code-aligned 6-bit rows           (host, native packer)
        -> pack_call_windows_rows16             (kernel; reads the rows)
        -> the table's probe                    (kernel: probe_wide,
                                                 probe_bucket or probe_cmph,
                                                 ops/probe.table_probe)
        -> device_automaton_packed              (kernel)
        -> one (B, 13) int32 block per chunk    (one device->host copy)
        -> best-call scoring                    (native C++, exact Python
                                                 for fusion rows)

Rows the device automaton flags (more than REC_CAP records, or fields that
do not fit the 16-bit packing) are re-called exactly on the host through
the table's host probe and the golden automaton.

With keep_hits (--debug-hits) or order_constraint the caller gathers every
hit with its value words instead (gather_hits_batch: probe_wide_aux on a
wide table, which reads the transfer rows itself; the pack, then
probe_bucket_aux or probe_cmph_aux on the other layouts) and runs the
golden automaton and scoring on the host.

On a CUDA device every step above runs its kernel; with device="cpu" the
same path runs each kernel's plain PyTorch version.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np
import torch

from ..core import alphabet
from ..core.config import CallConfig, DeviceConfig
from ..core.function_map import UNDEFINED_FUNCTION
from ..golden.call import (BestCall, KmerCall, KmerHit, find_best_call,
                           process_hits, valid_call_windows)
from ..io import fasta as fasta_io
from ..ops import automaton, kmer_pack, probe
from ..table import WideKmerTable


def bucket_length(sub: fasta_io.SequenceBatch) -> int:
    """The power-of-two sequence length bucket L >= 128 of a sub-batch."""
    nat = int(sub.lengths.max()) if len(sub) else 128
    L = 128
    while L < nat:
        L *= 2
    return L


def pad_bucketed(sub: fasta_io.SequenceBatch, rows: int):
    """Pad a sub-batch to at least ``rows`` rows and its length bucket
    (bucket_length) -> (codes (rows, L) uint8 padded with INVALID_CODE,
    lengths (rows,) int32, 0 on padding rows)."""
    lens = sub.lengths
    L = bucket_length(sub)
    codes = np.full((max(rows, len(sub)), L), alphabet.INVALID_CODE,
                    dtype=np.uint8)
    lengths = np.zeros(codes.shape[0], dtype=np.int32)
    lengths[:len(sub)] = lens
    for i in range(len(sub)):
        codes[i, :lens[i]] = sub.codes[sub.offsets[i]:sub.offsets[i + 1]]
    return codes, lengths


def resolve_device(device) -> torch.device:
    """The caller's device; a CUDA device with no CUDA present raises
    instead of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch versions")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


class SequenceResult:
    """Per-sequence outcome.  `calls` may be a thunk: the production
    output path reads only `best`, so the KmerCall row objects are
    materialized on first access.  `hits` is kept only on request
    (call_batch(keep_hits=True))."""

    __slots__ = ("seq_id", "length", "best", "hits", "_calls")

    def __init__(self, seq_id: str, length: int, calls, best: BestCall,
                 hits: list[KmerHit] | None = None):
        self.seq_id = seq_id
        self.length = length
        self.best = best
        self.hits = hits
        self._calls = calls

    @property
    def calls(self) -> list[KmerCall]:
        if callable(self._calls):
            self._calls = self._calls()
        return self._calls


class FunctionCaller:
    """Batched caller on one device against a table of any layout that
    ops/probe.table_probe serves (wide, cuckoo, reference CMPH)."""

    def __init__(self, table, function_index: list[str],
                 config: CallConfig = CallConfig(),
                 device_config: DeviceConfig = DeviceConfig(),
                 device="cuda"):
        # raises TypeError for a table type with no device probe
        probe.table_probe(table)
        self.table = table
        self.function_index = function_index
        self.config = config
        self.device_config = device_config
        self.device = resolve_device(device)
        try:
            self.hypo_index = function_index.index("hypothetical protein")
        except ValueError:
            self.hypo_index = -1
            if config.ignore_hypothetical:
                # the reference exits here (call_functions.tcc:269-274)
                raise ValueError("Cannot find hypothetical protein index")
        # the probe and aux rows, uploaded at first use (device_tables)
        self._tables = None
        self._aux = None
        self._fmeta = None
        # call_batch runs concurrently on the service's executor threads:
        # serialize the lazy fills (a double miss would upload the
        # multi-hundred-MB table twice) and the counters' updates
        self._cache_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        # device-automaton fallback accounting: rows processed vs rows
        # re-called on the host (REC_CAP overflow / 16-bit packing guard)
        self.rows_processed = 0
        self.rows_host_fallback = 0

    @property
    def host_fallback_frac(self) -> float:
        return (self.rows_host_fallback / self.rows_processed
                if self.rows_processed else 0.0)

    def function_at_index(self, idx: int) -> str:
        if idx == UNDEFINED_FUNCTION:
            return ""
        return self.function_index[idx]

    # -- device path ---------------------------------------------------------

    def _to_device(self, a: np.ndarray, device=None) -> torch.Tensor:
        """A host array's words as int32 on ``device`` (the caller's by
        default)."""
        device = self.device if device is None else device
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
        if device.type == "cuda":
            # pinned + non_blocking: the copy queues behind earlier chunks
            # instead of making the host wait for them
            return t.pin_memory().to(device, non_blocking=True)
        return t

    def _chunk_rows(self, sub: fasta_io.SequenceBatch):
        """One sub-batch's transfer rows on the host -> (packed_rows,
        start_row, lengths, L, W): rows padded to a power of two from 64
        when the chunk is under half of call_batch (a tail, or long-protein
        splitting) so padding work stays proportional, L the 128-multiple
        of its longest sequence, W the probe width (the smallest
        16-multiple covering every valid window)."""
        rows = self.device_config.call_batch
        if len(sub) <= rows // 2:
            rows = 64
            while rows < len(sub):
                rows <<= 1
        lens = sub.lengths
        nat = int(lens.max()) if len(sub) else 128
        L = 128
        while L < nat:
            L += 128
        packed_rows, start_row, lengths = kmer_pack.pack_u6_rows_host(
            sub.codes, sub.offsets, rows, L)
        # window p is valid iff p + k <= len; max p = nat - k
        k = self.config.k
        W = min(L, max(16, -(-(max(nat, k) - k + 1) // 16) * 16))
        return packed_rows, start_row, lengths, L, W

    def _ignore_function(self) -> int:
        """The function whose hits the call path drops (-1: none)."""
        return self.hypo_index if self.config.ignore_hypothetical else -1

    def _automaton(self, found, fm, lengths) -> torch.Tensor:
        cfg = self.config
        return automaton.device_automaton_packed(
            found, fm, lengths, cfg.min_hits, cfg.max_gap, cfg.k,
            mad_floor=cfg.mad_floor, len_window=cfg.len_mad_window)

    def _dispatch_device(self, sub: fasta_io.SequenceBatch) -> torch.Tensor:
        """Enqueue one sub-batch; returns the (rows, 13) device block."""
        *host, L, W = self._chunk_rows(sub)
        packed_rows, start_row, lengths = (self._to_device(a) for a in host)
        hi, lo, valid = kmer_pack.pack_call_windows_rows16(
            packed_rows, start_row, lengths, L, W)
        fn, geometry = probe.table_probe(self.table)
        found, fm = fn(hi, lo, valid, *self.device_tables(), **geometry,
                       ignore_function=self._ignore_function())
        return self._automaton(found, fm, lengths)

    def probe_geometry(self) -> dict:
        """The table's geometry as its probe wrappers take it (salts and
        bits, or the BDZ seed, r and m)."""
        return probe.table_probe(self.table)[1]

    def device_tables(self, with_aux: bool = False) -> tuple:
        """The table's words on the caller's device, as its probe takes
        them: the layout's to_device(device), then with_aux its
        aux_to_device(device) (wide: packed, ov_packed[, aux, ov_aux];
        cuckoo: packed[, aux]; CMPH: g, vfm[, vrec]).  Each part
        is uploaded at first use: matrix distance on a wide table reads
        neither (it holds distance rows), and the call path never reads
        the aux part."""
        tables, aux = self._tables, self._aux
        if tables is None or (with_aux and aux is None):
            with self._cache_lock:
                # published only once uploaded: another thread sees None
                # or the whole tuple
                if self._tables is None:
                    self._tables = self.table.to_device(self.device)
                if with_aux and self._aux is None:
                    self._aux = self.table.aux_to_device(self.device)
                tables, aux = self._tables, self._aux
        return tables + aux if with_aux else tables

    def transfer_rows(self, codes: np.ndarray, offsets: np.ndarray,
                      rows: int, L: int, device=None):
        """Concatenated codes + offsets (a sub-batch's, as on the fused
        path; L a multiple of 16) -> (t_rows, start_row, lengths) on
        ``device`` (the caller's by default; pack_u6_rows_host), as the
        kernels that read transfer rows take them."""
        return tuple(self._to_device(a, device)
                     for a in kmer_pack.pack_u6_rows_host(codes, offsets,
                                                          rows, L))

    def _function_meta(self):
        """Per-function multipart flags and lexicographic ranks for the
        native best-call scorer (cached)."""
        if self._fmeta is None:
            with self._cache_lock:
                if self._fmeta is None:
                    names = self.function_index
                    is_multipart = np.asarray([" / " in n for n in names],
                                              dtype=np.uint8)
                    order = sorted(range(len(names)), key=lambda i: names[i])
                    lex_rank = np.empty(len(names), dtype=np.int32)
                    lex_rank[order] = np.arange(len(names), dtype=np.int32)
                    self._fmeta = (is_multipart, lex_rank)
        return self._fmeta

    def _native_best_call(self, valid, out, B, overflow):
        """Native margin-path scoring; returns list of BestCall | None
        (None = row needs the Python path), or None when unavailable."""
        from ..runtime import host

        if not host.available() or not self.function_index:
            return None
        is_multipart, lex_rank = self._function_meta()
        # overflow rows carry truncated record words (they are re-called
        # on the host); drop them so they can't trip the range check
        valid = valid & ~overflow[:, None]
        counts_per_row = valid.sum(axis=1)
        flat_fI = out["fI"][:B][valid]
        flat_count = out["count"][:B][valid]
        if flat_fI.size and int(flat_fI.max()) >= len(self.function_index):
            return None  # defensive: function table mismatch
        call_off = np.concatenate(
            [[0], np.cumsum(counts_per_row)]).astype(np.int64)
        kind, func, score, offset, f1, f2 = host.run_best_call(
            flat_fI, flat_count, call_off, is_multipart, lex_rank,
            self.config.merge_interior_thresh,
            self.config.merge_exterior_thresh,
            self.config.call_margin, self.config.pair_margin)
        # .tolist() once: per-element numpy-scalar conversion inside the
        # row loop dominates at thousands of rows per chunk
        kind_l = kind.tolist()
        func_l = func.tolist()
        score_l = score.tolist()
        offset_l = offset.tolist()
        f1_l, f2_l = f1.tolist(), f2.tolist()
        overflow_l = overflow.tolist()
        names = self.function_index
        res = []
        for i in range(B):
            k = kind_l[i]
            if overflow_l[i] or k == 3:
                res.append(None)
            elif k == 0:
                fi = func_l[i]
                res.append(BestCall(fi, names[fi], score_l[i], offset_l[i]))
            elif k == 2:
                res.append(BestCall(
                    UNDEFINED_FUNCTION, f"{names[f1_l[i]]} ?? {names[f2_l[i]]}",
                    score_l[i], offset_l[i]))
            else:
                res.append(BestCall(UNDEFINED_FUNCTION, "", 0.0, offset_l[i]))
        return res

    def _finalize_device(self, sub, packed_out) -> list[SequenceResult]:
        REC_CAP = automaton.REC_CAP
        m = packed_out.cpu().numpy()  # the chunk's single D2H copy
        out = automaton.unpack_records(m)
        B = len(sub)
        true_lens = sub.lengths.astype(np.int32)
        valid = out["call_valid"][:B]
        counts = np.where(valid, out["count"][:B], 0)
        fIs = np.where(valid, out["fI"][:B], -1)
        n_calls = valid.sum(axis=1)
        total_count = counts.sum(axis=1)
        overflow = out["n_recs"][:B] > REC_CAP

        # fast path: zero calls, or all calls share one function (collapse
        # folds them into a single entry; margin >= min score always holds
        # when any call exists with count >= min_hits)
        fs = np.sort(np.where(valid, fIs, np.int32(1 << 30)), axis=1)
        n_distinct = ((fs[:, :1] != (1 << 30)).astype(np.int64).ravel()
                      + ((fs[:, 1:] != fs[:, :-1])
                         & (fs[:, 1:] != (1 << 30))).sum(axis=1))
        margin = self.config.call_margin

        native_best = self._native_best_call(valid, out, B, overflow)

        def make_lazy(i):
            def build():
                return [KmerCall(int(out["start"][i, r]),
                                 int(out["end"][i, r]),
                                 int(out["count"][i, r]),
                                 int(out["fI"][i, r]),
                                 int(out["median"][i, r]),
                                 float(out["mad"][i, r]))
                        for r in range(REC_CAP) if valid[i, r]]
            return build

        # batch numpy->Python conversions (per-row scalar reads are slow)
        overflow_l = overflow.tolist()
        n_calls_l = n_calls.tolist()
        true_lens_l = true_lens[:B].tolist()
        total_count_l = total_count.tolist()
        fs0_l = fs[:, 0].tolist()
        n_distinct_l = n_distinct.tolist()
        ids = sub.ids

        with self._stats_lock:
            self.rows_processed += B
        results: list[SequenceResult] = [None] * B
        slow_rows = []
        for i in range(B):
            if overflow_l[i]:
                slow_rows.append(i)
                continue
            if n_calls_l[i] == 0:
                results[i] = SequenceResult(
                    ids[i], true_lens_l[i], [],
                    BestCall(UNDEFINED_FUNCTION, "", 0.0, 0.0))
                continue
            calls = make_lazy(i)
            if native_best is not None and native_best[i] is not None:
                best = native_best[i]
            elif n_distinct_l[i] == 1:
                score = float(total_count_l[i])
                if score >= margin:
                    fi = fs0_l[i]
                    best = BestCall(fi, self.function_at_index(fi), score,
                                    score)
                else:
                    best = BestCall(UNDEFINED_FUNCTION, "", 0.0, score)
            else:
                calls = calls()  # find_best_call needs the records
                best = find_best_call(calls, self.function_at_index,
                                      self.config)
            results[i] = SequenceResult(ids[i], true_lens_l[i], calls, best)

        with self._stats_lock:
            self.rows_host_fallback += len(slow_rows)
        for i in slow_rows:
            # exact host route for flush-heavy or over-long sequences
            seq = sub.codes[sub.offsets[i]:sub.offsets[i + 1]]
            calls = self.host_calls(seq)
            best = find_best_call(calls, self.function_at_index, self.config)
            results[i] = SequenceResult(sub.ids[i], int(true_lens[i]),
                                        calls, best)
        return results

    def host_calls(self, seq: np.ndarray) -> list[KmerCall]:
        """Exact host route for one sequence's codes: host table probe
        (lookup_np) -> golden automaton (process_hits)."""
        n = seq.shape[0]
        hi = np.zeros(max(n, 1), dtype=np.uint32)
        lo = np.zeros(max(n, 1), dtype=np.uint32)
        valid = np.zeros(max(n, 1), dtype=bool)
        h, l = alphabet.pack_codes_np(seq)
        hi[:h.shape[0]] = h
        lo[:l.shape[0]] = l
        v = valid_call_windows(seq)
        valid[:v.shape[0]] = v
        fo, r0, r1, _r2 = self.table.lookup_np(hi, lo)
        fo &= valid
        func = (r0 >> 16).astype(np.int32)
        mean = (r1 & 0xFFFF).astype(np.int32)
        if self.config.ignore_hypothetical:
            fo &= func != self.hypo_index
        hits = [KmerHit(int(p), 0, int(func[p]), int(mean[p]), 0, 0)
                for p in np.nonzero(fo)[0]]
        return process_hits(hits, float(n), self.config, self.hypo_index)

    # -- end-to-end --------------------------------------------------------

    @staticmethod
    def _permute_batch(batch: fasta_io.SequenceBatch, order: np.ndarray
                       ) -> fasta_io.SequenceBatch:
        """Reorder a batch's sequences (per-sequence slice + one
        concatenate; a variable-count np.repeat index is far slower)."""
        offs = np.asarray(batch.offsets, dtype=np.int64)
        lens = np.diff(offs)
        new_off = np.zeros(order.shape[0] + 1, np.int64)
        np.cumsum(lens[order], out=new_off[1:])
        codes = (np.concatenate(
            [batch.codes[offs[i]:offs[i + 1]] for i in order])
            if order.shape[0] else batch.codes[:0])
        return fasta_io.SequenceBatch(
            codes=codes,
            offsets=new_off.astype(batch.offsets.dtype),
            ids=[batch.ids[i] for i in order],
            deflines=[batch.deflines[i] for i in order])

    @staticmethod
    def _restore_order(results: list, order: np.ndarray) -> list:
        """Undo _permute_batch: results[j] belongs to input index
        order[j]; return them in input order."""
        n = order.shape[0]
        inv = np.empty(n, np.int64)
        inv[order] = np.arange(n)
        return [results[inv[i]] for i in range(n)]

    def call_batch(self, batch: fasta_io.SequenceBatch,
                   keep_hits: bool = False) -> list[SequenceResult]:
        cfg = self.device_config
        # keep_hits and the order_constraint gate (which reads
        # avg_from_end) take the exact host route over gathered hits
        exact = keep_hits or self.config.order_constraint
        n = len(batch)

        # cap rows x padded-length cells per chunk: one long protein must
        # not inflate the whole chunk's padded width
        CELL_BUDGET = 8 << 20
        lens_all = batch.lengths

        # length-sorted chunking: every chunk's (L, W) follows its OWN
        # longest sequence and the probe pays per window, so mixed-length
        # batches stop probing at the global max width.  Results are
        # restored to input order below.
        order = None
        if (cfg.sort_by_length and not exact and n > 1
                and np.any(lens_all[:-1] > lens_all[1:])):
            order = np.argsort(lens_all, kind="stable")
            batch = self._permute_batch(batch, order)
            lens_all = batch.lengths

        # probe-waste splitting (sorted batches only): cut chunks (floor
        # 1024 rows, only when padding exceeds ~15%) so W hugs each span's
        # own maximum
        useful = None
        if order is not None:
            # per-row useful windows floored at 16 to MATCH W's floor
            useful = np.zeros(n + 1, np.int64)
            np.cumsum(np.maximum(lens_all.astype(np.int64)
                                 - (self.config.k - 1), 16),
                      out=useful[1:])

        def subs():
            s = 0
            while s < n:
                e = min(s + cfg.call_batch, n)
                while e - s > 1:
                    lmax = int(lens_all[s:e].max())
                    L = max(128, -(-lmax // 128) * 128)
                    if (e - s) * L <= CELL_BUDGET:
                        break
                    e = s + max(1, (e - s) // 2)
                if useful is not None:
                    while e - s > 1024:
                        Wc = max(16, int(lens_all[e - 1]) - self.config.k + 1)
                        if (e - s) * Wc <= 1.15 * (useful[e] - useful[s]):
                            break
                        e = s + max(1024, (e - s) // 2)
                yield fasta_io.SequenceBatch(
                    codes=batch.codes[batch.offsets[s]:batch.offsets[e]],
                    offsets=batch.offsets[s:e + 1] - batch.offsets[s],
                    ids=batch.ids[s:e],
                    deflines=batch.deflines[s:e],
                )
                s = e

        if exact:
            results: list[SequenceResult] = []
            for sub in subs():
                L = bucket_length(sub)
                out = self._gather_hits(sub.codes, sub.offsets, len(sub), L,
                                        need_aux=True)
                results.extend(self._score_batch(sub, out, keep_hits))
            return results

        # bounded pipeline: up to DEPTH chunks enqueued on the device, so
        # host packing/scoring of chunk i overlaps device work on chunks
        # i+1..i+DEPTH, while capping the device buffers in flight
        DEPTH = 4
        results: list[SequenceResult] = []
        pending: deque = deque()
        for sub in subs():
            pending.append((sub, self._dispatch_device(sub)))
            if len(pending) >= DEPTH:
                s0, o0 = pending.popleft()
                results.extend(self._finalize_device(s0, o0))
        while pending:
            s0, o0 = pending.popleft()
            results.extend(self._finalize_device(s0, o0))
        if order is not None:
            results = self._restore_order(results, order)
        return results

    def gather_hits_batch(self, codes: np.ndarray, lengths: np.ndarray,
                          need_aux: bool = False):
        """(B, L) codes (L a multiple of 16, as pad_bucketed makes) ->
        position-aligned hit arrays.

        Returns (found, func, mean) or
        (found, func, mean, avg, median, var) when need_aux; found is
        masked by the call windows only (no hypothetical filter)."""
        B, L = codes.shape
        lengths = np.minimum(np.asarray(lengths, np.int64), L)
        offsets = np.zeros(B + 1, np.int64)
        np.cumsum(lengths, out=offsets[1:])
        flat = codes[np.arange(L)[None, :] < lengths[:, None]]
        return self._gather_hits(flat, offsets, B, L, need_aux)

    def _gather_hits(self, codes: np.ndarray, offsets: np.ndarray,
                     rows: int, L: int, need_aux: bool):
        """gather_hits_batch from concatenated codes + offsets: (rows, L)
        arrays."""
        out = self._gather_words(codes, offsets, rows, L, need_aux)
        found, fm = out[0], out[1].view(np.uint32)
        func = (fm >> 16).astype(np.int32)
        mean = (fm & 0xFFFF).astype(np.int32)
        if not need_aux:
            return found, func, mean
        r0, r1, r2 = (o.view(np.uint32) for o in out[2:])
        avg, _f2, _mean2, median, var = unpack_value_words(r0, r1, r2)
        return found, func, mean, avg, median, var

    def _gather_words(self, codes: np.ndarray, offsets: np.ndarray,
                      rows: int, L: int, need_aux: bool) -> list:
        """The hit probe of (rows, L) windows on the device -> [found, fm]
        or [found, fm, r0, r1, r2] as host arrays."""
        t_rows = self.transfer_rows(codes, offsets, rows, L)
        return [o.cpu().numpy() for o in gather_probe(
            self.table, t_rows, L, self.device_tables(need_aux), need_aux)]

    def _score_batch(self, sub, gathered,
                     keep_hits: bool) -> list[SequenceResult]:
        """Golden automaton + best-call scoring over a batch that
        gather_hits_batch(need_aux=True) gathered (the exact Python
        route)."""
        B = len(sub)
        true_lens = sub.lengths.astype(np.int32)
        found = gathered[0][:B].copy()
        func, mean, avg, median, var = (g[:B] for g in gathered[1:])
        if self.config.ignore_hypothetical:
            # skipped before any automaton state change
            # (ref: call_functions.tcc:285-289)
            found &= func != self.hypo_index
        results: list[SequenceResult] = []
        for i in range(B):
            true_len = int(true_lens[i])
            hits = [KmerHit(int(p), int(avg[i, p]), int(func[i, p]),
                            int(mean[i, p]), int(median[i, p]),
                            int(var[i, p])) for p in np.nonzero(found[i])[0]]
            calls = process_hits(hits, float(true_len), self.config,
                                 self.hypo_index)
            best = find_best_call(calls, self.function_at_index,
                                  self.config)
            results.append(SequenceResult(
                seq_id=sub.ids[i], length=true_len, calls=calls,
                best=best, hits=hits if keep_hits else None))
        return results

    def call_file(self, path, keep_hits: bool = False) -> list[SequenceResult]:
        return self.call_batch(fasta_io.read_fasta_batch(path), keep_hits)


def gather_probe(table, t_rows, L: int, tables: tuple, need_aux: bool):
    """The hit probe of the first L windows of transfer rows against one
    table's device words -> (found, fm[, r0, r1, r2]) tensors: on a wide
    table with aux probe_wide_aux (it reads the rows itself), else the
    pack and the layout's probe (ops/probe.table_probe)."""
    if need_aux and isinstance(table, WideKmerTable):
        return probe.probe_wide_aux(*t_rows, L, L, *tables,
                                    **probe.table_probe(table)[1])
    hi, lo, valid = kmer_pack.pack_call_windows_rows16(*t_rows, L, L)
    fn, geometry = probe.table_probe(table, need_aux)
    return fn(hi, lo, valid, *tables, **geometry)


def unpack_value_words(r0, r1, r2):
    """-> (avg_from_end, function_index, mean, median, var)"""
    r0 = np.asarray(r0)
    r1 = np.asarray(r1)
    return (r0 & 0xFFFF, r0 >> 16, r1 & 0xFFFF, r1 >> 16,
            np.asarray(r2) & 0xFFFF)
