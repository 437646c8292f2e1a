"""Production function caller: device hit gathering + call scoring.

Pipeline (ref architecture: call_functions.tcc:259-338):

  FASTA -> 16-code-aligned 6-bit rows           (host, native packer)
        -> pack_call_windows_rows16             (kernel; reads the rows)
        -> probe_wide                           (kernel; wide tagged table)
        -> device_automaton_packed              (kernel)
        -> one (B, 13) int32 block per chunk    (one device->host copy)
        -> best-call scoring                    (native C++, exact Python
                                                 for fusion rows)

Rows the device automaton flags (more than REC_CAP records, or fields that
do not fit the 16-bit packing) are re-called exactly on the host through
the table's host probe and the golden automaton.

On a CUDA device every step above runs its kernel; with device="cpu" the
same path runs each kernel's plain PyTorch version.
"""

from __future__ import annotations

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
from ..table.wide_table import WideKmerTable

_LATER_SLICE = ("needs the aux probe (--debug-hits), which a later slice of "
                "the PyTorch port adds")


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
    materialized on first access."""

    __slots__ = ("seq_id", "length", "best", "_calls")

    def __init__(self, seq_id: str, length: int, calls, best: BestCall):
        self.seq_id = seq_id
        self.length = length
        self.best = best
        self._calls = calls

    @property
    def calls(self) -> list[KmerCall]:
        if callable(self._calls):
            self._calls = self._calls()
        return self._calls


class FunctionCaller:
    """Batched caller against a WideKmerTable on one device."""

    def __init__(self, table: WideKmerTable, function_index: list[str],
                 config: CallConfig = CallConfig(),
                 device_config: DeviceConfig = DeviceConfig(),
                 device="cuda"):
        if not isinstance(table, WideKmerTable):
            raise NotImplementedError(
                f"{type(table).__name__}: only the wide table layout is "
                "ported; the other layouts come in a later slice")
        if config.order_constraint:
            raise NotImplementedError(f"order_constraint {_LATER_SLICE}")
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
        self._tables = table.to_device(self.device)
        self._fmeta = None
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

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
        if self.device.type == "cuda":
            # pinned + non_blocking: the copy queues behind earlier chunks
            # instead of making the host wait for them
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _dispatch_device(self, sub: fasta_io.SequenceBatch) -> torch.Tensor:
        """Enqueue one sub-batch; returns the (rows, 13) device block."""
        rows = self.device_config.call_batch
        if len(sub) <= rows // 2:
            # undersized chunk (tail, or long-protein splitting): shrink to
            # the next power of two so padding work stays proportional
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
        # probe width: smallest 16-multiple covering every valid window
        # (window p is valid iff p + k <= len; max p = nat - k)
        cfg = self.config
        k = cfg.k
        W = min(L, max(16, -(-(max(nat, k) - k + 1) // 16) * 16))
        packed_rows, start_row, lengths = (
            self._to_device(a) for a in (packed_rows, start_row, lengths))
        hi, lo, valid = kmer_pack.pack_call_windows_rows16(
            packed_rows, start_row, lengths, L, W)
        t = self.table
        found, fm = probe.probe_wide(
            hi, lo, valid, *self._tables, salt=t.salt, bits=t.bits,
            ov_salt=t.ov_salt, ov_bits=t.ov_bits,
            has_overflow=t.ov_items > 0,
            ignore_function=(self.hypo_index if cfg.ignore_hypothetical
                             else -1))
        return automaton.device_automaton_packed(
            found, fm, lengths, cfg.min_hits, cfg.max_gap, k,
            mad_floor=cfg.mad_floor, len_window=cfg.len_mad_window)

    def _function_meta(self):
        """Per-function multipart flags and lexicographic ranks for the
        native best-call scorer (cached)."""
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
        if keep_hits:
            raise NotImplementedError(f"keep_hits {_LATER_SLICE}")
        cfg = self.device_config
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
        if (cfg.sort_by_length and n > 1
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

    def gather_hits_batch(self, codes, lengths, need_aux: bool = False):
        raise NotImplementedError(f"gather_hits_batch {_LATER_SLICE}")
