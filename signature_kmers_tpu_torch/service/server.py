"""Batched annotation service on one device or one process's mesh.

Service-layer equivalent of the reference's (vestigial) kmers-server
(endpoint surface modeled on kser_request.cc:273-489).  Front-end is
asyncio HTTP; POST /query bodies are funneled through a shared queue so
concurrent clients share caller batches (up to four batches in flight —
see _QueryBatcher).  Every response's status line, headers and body are
the JAX package's for the same request; /version names this package.

Endpoints (surface modeled on kser_request.cc:273-489):
  GET  /version               -> framework + table info
  GET  /quit                  -> shut the server down
  GET  /dump_sizes            -> table size accounting
  GET  /dump_mapping          -> list keyed auxiliary mappings
  GET  /genus_lookup/<genus>  -> genome name from gnames/
  GET  /checkpoint            -> persist live table state to the data dir
  POST /add                   -> final.kmers lines; extend the live table
  POST /mapping/<key>/add     -> build/extend a named auxiliary k-mer table
  POST /mapping/<key>/lookup  -> FASTA body; probe a named mapping
  POST /mapping/<key>/matrix  -> FASTA body; shared-k-mer pair counts
                                 against a named mapping
  POST /lookup                -> FASTA body; per-k-mer hit dump per sequence
  POST /query                 -> FASTA body; call TSV (id function index score)
  POST /fq_lookup             -> FASTQ body; six-frame translated calls
  POST /matrix                -> FASTA body; distance TSV with scores

Request handlers run on the event loop's executor threads, so several
call FunctionCaller.call_batch at once; the caller serializes its lazy
table uploads and its counters, and every thread issues its work on the
device's default stream.

With a mesh (serve --mesh) the caller is a ParallelFunctionCaller over the
(dp, tp) mesh, /lookup gathers hits over it, and /matrix gathers its mask
through it and counts pairs over every mesh device.  With multihost the
mesh spans processes: rank 0 serves HTTP and broadcasts each dispatch to
the other ranks, which run service/multihost.follower_loop.
"""

from __future__ import annotations

import asyncio
import dataclasses
import io
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np

from .. import __version__
from ..core import alphabet
from ..core.config import Config
from ..io import fasta as fasta_io, formats
from ..models import pipeline
from ..models.function_caller import FunctionCaller
from ..models.matrix_distance import MatrixDistance


@dataclasses.dataclass(frozen=True)
class _Engines:
    """Immutable table + engine snapshot.

    Read handlers grab ONE reference and use it for the whole request;
    /add builds a NEW snapshot and swaps the attribute (atomic under the
    GIL), so reads never block behind a rebuild and in-flight requests
    finish on the table they started with (copy-on-write — the service
    lock covers only writers)."""

    table: object
    caller: FunctionCaller
    distance: MatrixDistance


class _QueryBatcher:
    """Coalesces concurrent POST /query bodies into shared caller batches.

    While a batch is in call_batch, newly arriving requests queue up and
    are merged into the NEXT batch — many small concurrent requests ride
    one call instead of serializing (the in-process replacement for the
    reference server's request threadpool, kmer_request_server.cc:56-126,
    recast for a batched device).

    Up to `depth` batches are in flight at once (default 4, env
    SKT_SERVE_DEPTH), each on its own executor thread: while batch N's
    device->host copy and host scoring run, batch N+1's host packing and
    upload proceed.  All of them issue on the device's default stream.

    Workers beyond the first run only while `min_fill` sequences are
    pending (env SKT_SERVE_MIN_FILL; checked at a worker's start and in
    each drain round): a dispatch has a fixed cost (multihost: the
    serialized broadcast and collectives), and eager workers would race
    each other down to one-request batches.  The default is 64 under
    multihost (the JAX package measured 16.6 qps ungated against 42.6
    gated on its two-process CPU mesh) and 0 otherwise.  Requests never
    strand: the last draining worker re-kicks."""

    def __init__(self, service: "AnnotationService"):
        self.service = service
        self.pending: list = []
        self.depth = max(1, int(os.environ.get("SKT_SERVE_DEPTH", "4")))
        self.min_fill = max(0, int(os.environ.get(
            "SKT_SERVE_MIN_FILL", "64" if service.multihost else "0")))
        self.inflight = 0
        self.batches_run = 0  # observability / tests
        self.seqs_run = 0     # total sequences across coalesced batches
        self.call_ms = 0.0    # cumulative wall ms inside call_batch
        self.call_max_ms = 0.0  # slowest single call (tail attribution)
        # where a request's time goes besides call_batch (host clock, ms
        # summed over requests or rounds; read by harnesses, not served):
        # the loop thread's FASTA parse, the wait from enqueue to the
        # start of its round, and the loop thread's merge and formatting
        self.requests_run = 0
        self.parse_ms = 0.0
        self.wait_ms = 0.0
        self.merge_ms = 0.0
        self.format_ms = 0.0
        self._drain_tasks: set = set()  # strong refs: bare tasks can be GC'd

    async def query(self, body: bytes) -> str:
        loop = asyncio.get_event_loop()
        t0 = time.perf_counter()
        batch = fasta_io.SequenceBatch.from_records(fasta_io.iter_fasta(body))
        t1 = time.perf_counter()
        self.parse_ms += (t1 - t0) * 1e3
        fut = loop.create_future()
        self.pending.append((batch, fut, t1))
        self._kick(loop)
        return await fut

    def _underfilled(self) -> bool:
        return bool(self.min_fill) and sum(
            len(b) for b, _, _ in self.pending) < self.min_fill

    def _kick(self, loop):
        if not self.pending or self.inflight >= self.depth:
            return
        if self.inflight and self._underfilled():
            return  # let the batch fill: a draining worker re-kicks
        self.inflight += 1
        t = loop.create_task(self._drain())
        self._drain_tasks.add(t)
        t.add_done_callback(self._drain_tasks.discard)

    async def _drain(self):
        loop = asyncio.get_event_loop()
        try:
            while self.pending:
                if self.inflight > 1 and self._underfilled():
                    # leave a small remainder for a fuller batch: another
                    # worker is still running and drains it, or the last
                    # worker's re-kick does
                    break
                work, self.pending = self.pending, []
                t_round = time.perf_counter()
                self.requests_run += len(work)
                self.wait_ms += sum(t_round - t for _, _, t in work) * 1e3
                try:
                    # merge INSIDE the try: a failure here must fail this
                    # round's waiters, not kill the worker and strand
                    # every coalesced client until timeout
                    batches = [b for b, _, _ in work]
                    merged = fasta_io.SequenceBatch(
                        codes=np.concatenate([b.codes for b in batches]),
                        offsets=np.concatenate(
                            [batches[0].offsets]
                            + [b.offsets[1:] + off for b, off in zip(
                                batches[1:],
                                np.cumsum([int(b.offsets[-1])
                                           for b in batches])[:-1])]
                        ).astype(np.int32),
                        ids=[i for b in batches for i in b.ids],
                        deflines=[d for b in batches for d in b.deflines],
                    )
                    # one lock-free engines-snapshot read: an /add that
                    # lands mid-batch swaps the attribute for the NEXT
                    # batch while this one finishes on its old table
                    t0 = time.perf_counter()
                    self.merge_ms += (t0 - t_round) * 1e3
                    results = await loop.run_in_executor(
                        None, self.service._call_batch, merged)
                    dt_ms = (time.perf_counter() - t0) * 1e3
                    self.call_ms += dt_ms
                    self.call_max_ms = max(self.call_max_ms, dt_ms)
                    self.batches_run += 1
                    self.seqs_run += len(merged)
                except Exception as exc:  # noqa: BLE001 — fail all waiters
                    for _b, fut, _t in work:
                        if not fut.done():
                            fut.set_exception(exc)
                    continue
                t0 = time.perf_counter()
                pos = 0
                for b, fut, _t in work:
                    out = io.StringIO()
                    for res in results[pos:pos + len(b)]:
                        out.write(formats.format_call_row(
                            res.seq_id, res.best.function,
                            res.best.function_index, res.best.score))
                    pos += len(b)
                    if not fut.done():
                        fut.set_result(out.getvalue())
                self.format_ms += (time.perf_counter() - t0) * 1e3
        finally:
            self.inflight -= 1
            # requests that arrived while this worker was exiting its
            # last executor await would otherwise strand until the next
            # query() — re-kick so they get a worker immediately
            self._kick(loop)


def write_kmer_distribution(table, function_index: list[str], path) -> None:
    """Per-function signature-k-mer counts (ref: write_kmer_distribution
    call, kmers-server.cc:254-263; the writer itself lives in the sibling
    PATRIC repo).  Rows: function_index \\t count \\t function.  Host only
    (table.occupied()): no device is touched."""
    _hi, _lo, v0, _v1, _v2 = table.occupied()
    counts = np.bincount(v0 >> 16, minlength=len(function_index))
    with open(path, "w") as fh:
        for fi, cnt in enumerate(counts):
            if cnt:
                name = function_index[fi] if fi < len(function_index) else ""
                fh.write(f"{fi}\t{int(cnt)}\t{name}\n")


class AnnotationService:
    def __init__(self, data_dir, config: Config = Config(), device="cuda",
                 kmer_version: str | None = None, mesh=None,
                 multihost: bool = False):
        """device: where the caller and matrix distance run ("cuda" runs
        the kernels and raises without CUDA; "cpu" their plain
        versions).  mesh: a parallel/mesh.Mesh to dispatch onto instead
        (queries split over dp, the table over tp, by a
        ParallelFunctionCaller); /add rebuilds the sharded tables under
        the writer lock and swaps the snapshot.  multihost: the mesh
        spans processes; rank 0 serves HTTP and broadcasts every
        collective dispatch, the other ranks run
        service.multihost.follower_loop."""
        self.config = config
        self.data_dir = data_dir
        self.device = device
        self.mesh = mesh
        self.multihost = multihost
        self.kmer_version = kmer_version
        if multihost:
            # re-arm the module's quit latch for a service built after an
            # earlier serve/quit cycle in this process
            from .multihost import reset_quit

            reset_quit()
        table, self.function_index = pipeline.load_data_dir(
            data_dir, config)
        self.engines = self._make_engines(table)
        # writer lock: serializes /add, /mapping/<k>/add, /checkpoint.
        # Readers snapshot self.engines and run lock-free (see _Engines).
        self._lock = asyncio.Lock()
        self.batcher = _QueryBatcher(self)
        # keyed auxiliary mappings (ref: /mapping/<key>/* endpoints,
        # kser_request.cc:440-489): named k-mer tables built via
        # /mapping/<key>/add and probed via /mapping/<key>/lookup
        self.mappings: dict[str, object] = {}

    def _make_engines(self, table) -> _Engines:
        pcaller = None
        if self.mesh is not None:
            from ..parallel import distributed
            from ..parallel.parallel_caller import ParallelFunctionCaller

            caller = pcaller = ParallelFunctionCaller(
                table, self.function_index, self.config.call,
                self.config.device, mesh=self.mesh)
            if self.multihost and distributed.is_main():
                from .multihost import MultihostCaller

                # rank 0 broadcasts each dispatch; the followers drive
                # the inner caller from follower_loop
                caller = MultihostCaller(pcaller)
        else:
            caller = FunctionCaller(table, self.function_index,
                                    self.config.call, self.config.device,
                                    device=self.device)
        distance = MatrixDistance(table, self.function_index,
                                  self.config.distance, self.config.device,
                                  device=self.device)
        if pcaller is not None:
            # /matrix gathers its hits against the tp-split table
            distance.mesh_caller = pcaller
        return _Engines(table, caller, distance)

    # single-snapshot convenience views (one attribute read each — fine
    # for handlers that touch the engine once; multi-step handlers should
    # bind `eng = self.engines` explicitly)
    @property
    def table(self):
        return self.engines.table

    @property
    def distance(self) -> MatrixDistance:
        return self.engines.distance

    def _call_batch(self, batch, keep_hits: bool = False):
        """One lock-free engines-snapshot read and one call
        (copy-on-write /add).  Multihost: the snapshot read and the
        dispatch's broadcast are atomic against /add's broadcast and swap
        (multihost._dispatch_lock); the lock is held through the dispatch
        only, and collection (a local read) runs off it, so executor
        threads overlap up to the batcher's depth."""
        if self.multihost:
            from .multihost import _dispatch_lock

            with _dispatch_lock:
                caller = self.engines.caller
                handle = caller.dispatch_batch(batch, keep_hits=keep_hits)
            return caller.collect_batch(handle)
        return self.engines.caller.call_batch(batch, keep_hits=keep_hits)

    def warm(self, length: int = 384, max_rows: int = 1024) -> int:
        """Run one call per dispatch shape that coalesced batches hit.

        Batch row counts land on a pow2 grid (FunctionCaller.
        _dispatch_device) and the code width on a 128 grid.  The first
        calls load the kernel libraries, upload the table's probe rows
        and fill the pinned and device allocators' pools, which would
        otherwise land on the first requests' latency.  Returns the
        number of warm calls run."""
        # two lengths per rows count: the requested length (whose probe
        # width W = 16-grid of len-k+1 is what real queries of that length
        # use) AND its 128-bucket max (W = L)
        lens = sorted({max(1, length),
                       -(-max(1, length) // 128) * 128})
        n_shapes = 0
        for Lw in lens:
            reps = -(-Lw // 20)  # tile to cover ANY warm length
            seq = alphabet.encode_seq("ACDEFGHIKLMNPQRSTVWY" * reps)[:Lw]
            rows = 64
            while rows <= min(max_rows, self.config.device.call_batch):
                batch = fasta_io.SequenceBatch(
                    codes=np.tile(seq, rows),
                    offsets=(np.arange(rows + 1) * Lw).astype(np.int32),
                    ids=[f"w{i}" for i in range(rows)],
                    deflines=[""] * rows)
                self._call_batch(batch)
                n_shapes += 1
                rows <<= 1
        return n_shapes

    # -- request handlers --------------------------------------------------

    def version_text(self) -> str:
        # "kmer\t<version>" line matches the reference's /version payload
        # when a data-version string is configured (kser_request.cc:283-296
        # with kmers-server.cc:48 --kmer-version)
        head = (f"kmer\t{self.kmer_version}\n" if self.kmer_version
                else "")
        return (head +
                f"signature_kmers_tpu_torch {__version__}\n"
                f"kmers {self.table.n_items}\n"
                f"table_slots {self.table.size}\n"
                f"functions {len(self.function_index)}\n")

    def query_text(self, body: bytes) -> str:
        batch = fasta_io.SequenceBatch.from_records(
            fasta_io.iter_fasta(body))
        out = io.StringIO()
        for res in self._call_batch(batch):
            out.write(formats.format_call_row(
                res.seq_id, res.best.function, res.best.function_index,
                res.best.score))
        return out.getvalue()

    def lookup_text(self, body: bytes) -> str:
        batch = fasta_io.SequenceBatch.from_records(
            fasta_io.iter_fasta(body))
        out = io.StringIO()
        for res in self._call_batch(batch, keep_hits=True):
            for h in res.hits or []:
                fn = (self.function_index[h.function_index]
                      if h.function_index < len(self.function_index) else "")
                out.write(f"{res.seq_id}\t{h.pos}\t{fn}\t{h.mean}\t"
                          f"{h.median}\t{h.var}\n")
        return out.getvalue()

    def add_text(self, body: bytes, _broadcast: bool = True) -> str:
        """Add signature k-mers (final.kmers text lines) to the live table.

        Service-layer analog of the reference's POST /add
        (kser_request.cc:414-489).  The merged table is rebuilt on the
        host (table.build_table) — adds are rare admin operations; reads
        stay on the static fast path.  Multihost: rank 0 broadcasts the
        body first, under the dispatch lock held across its own rebuild
        and swap, so every rank rebuilds the same table (the followers
        call this with _broadcast=False)."""
        if self.multihost and _broadcast:
            from .multihost import _dispatch_lock, broadcast_add

            with _dispatch_lock:
                broadcast_add(body)
                return self._add_apply(body)
        return self._add_apply(body)

    def _add_apply(self, body: bytes) -> str:
        from ..table import build_table

        his, los, v0s, v1s, v2s = [], [], [], [], []
        for line in body.decode("latin-1").splitlines():
            parts = line.rstrip().split("\t")
            if len(parts) < 3 or len(parts[0]) != 8:
                continue
            h, l = alphabet.pack_kmer_str(parts[0])
            avg, fn = int(parts[1]) & 0xFFFF, int(parts[2]) & 0xFFFF
            mean = int(parts[3]) & 0xFFFF if len(parts) > 3 and parts[3] else 0
            median = int(parts[4]) & 0xFFFF if len(parts) > 4 and parts[4] else 0
            var = int(parts[5]) & 0xFFFF if len(parts) > 5 and parts[5] else 0
            his.append(h)
            los.append(l)
            v0s.append((fn << 16) | avg)
            v1s.append((median << 16) | mean)
            v2s.append(var)
        if not his:
            return "added 0\n"
        hi, lo, v0, v1, v2 = self.table.occupied()
        nh = np.asarray(his, dtype=np.uint32)
        nl = np.asarray(los, dtype=np.uint32)
        # new entries override existing ones with the same key
        old_keys = (hi.astype(np.uint64) << 24) | lo
        new_keys = (nh.astype(np.uint64) << 24) | nl
        keep = ~np.isin(old_keys, new_keys)
        table = build_table(
            np.concatenate([hi[keep], nh]),
            np.concatenate([lo[keep], nl]),
            np.concatenate([v0[keep], np.asarray(v0s, np.uint32)]),
            np.concatenate([v1[keep], np.asarray(v1s, np.uint32)]),
            np.concatenate([v2[keep], np.asarray(v2s, np.uint32)]),
            self.config.table)
        # copy-on-write swap: in-flight readers keep the old snapshot
        self.engines = self._make_engines(table)
        return f"added {len(his)}\n"

    def fq_lookup_text(self, body: bytes) -> str:
        """POST /fq_lookup: FASTQ body; six-frame translated function calls.

        The reference routes this to ``FqProcessRequest``
        (kser_request.cc:473-476), implemented in the external PATRIC
        kmer-annotation-service repo: DNA reads are translated in all six
        frames and streamed through the protein k-mer lookup.  Output here
        is one row per called read: ``id \\t frame \\t function \\t index
        \\t score`` for the best-scoring frame (ties -> the earlier frame
        in +1 +2 +3 -1 -2 -3 order); uncalled reads are omitted.
        """
        from ..core import dna
        from ..io import fastq as fastq_io

        reads = list(fastq_io.iter_fastq(body))
        ids, defs, frames, seqs = [], [], [], []
        for rec in reads:
            for frame, pep in dna.six_frame_translations(rec.seq):
                if len(pep) < self.config.call.k:
                    continue
                ids.append(rec.id)
                defs.append("")
                frames.append(frame)
                seqs.append(pep)
        if not ids:
            return ""
        batch = fasta_io.SequenceBatch.from_records(
            fasta_io.FastaRecord(i, d, s)
            for i, d, s in zip(ids, defs, seqs))
        best: dict[str, tuple[float, int, object]] = {}
        order: list[str] = []
        for frame, res in zip(frames, self._call_batch(batch)):
            if res.best.function_index == 0xFFFF:
                continue
            if res.seq_id not in best:
                order.append(res.seq_id)
            prev = best.get(res.seq_id)
            if prev is None or res.best.score > prev[0]:
                best[res.seq_id] = (res.best.score, frame, res.best)
        out = io.StringIO()
        for rid in order:
            score, frame, b = best[rid]
            out.write(f"{rid}\t{frame:+d}\t{b.function}\t"
                      f"{b.function_index}\t{formats.cxx_num(score)}\n")
        return out.getvalue()

    def dump_sizes_text(self) -> str:
        """ref endpoint surface: GET /dump_sizes (kser_request.cc:273-412).

        The query_* counters expose the batcher's coalescing: mean
        coalesced batch size = query_seqs / query_batches."""
        return (f"kmers\t{self.table.n_items}\n"
                f"buckets\t{self.table.n_buckets}\n"
                f"packed_bytes\t{self.table.packed.nbytes}\n"
                f"aux_bytes\t{self.table.aux.nbytes}\n"
                f"functions\t{len(self.function_index)}\n"
                f"query_batches\t{self.batcher.batches_run}\n"
                f"query_seqs\t{self.batcher.seqs_run}\n"
                f"query_call_ms\t{self.batcher.call_ms:.1f}\n"
                f"query_call_max_ms\t{self.batcher.call_max_ms:.1f}\n"
                f"query_depth\t{self.batcher.depth}\n")

    def genus_lookup_text(self, genus: str) -> str:
        """GET /genus_lookup/<genus>: resolves a genome name from the
        data dir's gnames/ directory when present."""
        p = Path(self.data_dir) / "gnames" / genus
        if p.is_file():
            return p.read_text(encoding="latin-1")
        return ""

    @staticmethod
    def _parse_kmer_lines(body: bytes):
        his, los, v0s = [], [], []
        for line in body.decode("latin-1").splitlines():
            parts = line.rstrip().split("\t")
            if len(parts) < 3 or len(parts[0]) != 8:
                continue
            h, l = alphabet.pack_kmer_str(parts[0])
            his.append(h)
            los.append(l)
            v0s.append(((int(parts[2]) & 0xFFFF) << 16)
                       | (int(parts[1]) & 0xFFFF))
        return (np.asarray(his, np.uint32), np.asarray(los, np.uint32),
                np.asarray(v0s, np.uint32))

    def mapping_add_text(self, key: str, body: bytes) -> str:
        from ..table.bucket_table import BucketKmerTable

        hi, lo, v0 = self._parse_kmer_lines(body)
        if key in self.mappings:
            t = self.mappings[key]
            ohi, olo, ov0, ov1, ov2 = t.occupied()
            old_keys = (ohi.astype(np.uint64) << 24) | olo
            new_keys = (hi.astype(np.uint64) << 24) | lo
            keep = ~np.isin(old_keys, new_keys)
            hi = np.concatenate([ohi[keep], hi])
            lo = np.concatenate([olo[keep], lo])
            v0 = np.concatenate([ov0[keep], v0])
        z = np.zeros_like(v0)
        self.mappings[key] = BucketKmerTable.build(hi, lo, v0, z, z,
                                                   self.config.table)
        return f"mapping {key}: {self.mappings[key].n_items} kmers\n"

    def mapping_lookup_text(self, key: str, body: bytes) -> str:
        from ..golden.call import valid_call_windows

        t = self.mappings.get(key)
        if t is None:
            return ""
        batch = fasta_io.SequenceBatch.from_records(fasta_io.iter_fasta(body))
        out = io.StringIO()
        for i in range(len(batch)):
            codes = batch.codes[batch.offsets[i]:batch.offsets[i + 1]]
            hi, lo = alphabet.pack_codes_np(codes)
            ok = valid_call_windows(codes)
            found, r0, _, _ = t.lookup_np(hi, lo)
            found &= ok
            for p in np.nonzero(found)[0]:
                out.write(f"{batch.ids[i]}\t{int(p)}\t"
                          f"{int(r0[p]) >> 16}\t{int(r0[p]) & 0xFFFF}\n")
        return out.getvalue()

    def mapping_matrix_text(self, key: str, body: bytes) -> str:
        """Keyed distance: pairs of query sequences sharing k-mers of the
        named mapping (ref: keyed MatrixRequest dispatch,
        kser_request.cc:444-489).  Output rows 'id1 id2 count score' with
        score = count/(len1+len2) (matrix_distance.h:152-168).  No
        protein-length filter: keyed mappings carry no length statistics.
        """
        from ..golden.call import valid_call_windows

        t = self.mappings.get(key)
        if t is None:
            return ""
        batch = fasta_io.SequenceBatch.from_records(fasta_io.iter_fasta(body))
        kmer_seqs: dict[tuple[int, int], set[int]] = {}
        lens = []
        for i in range(len(batch)):
            codes = batch.codes[batch.offsets[i]:batch.offsets[i + 1]]
            lens.append(codes.shape[0])
            hi, lo = alphabet.pack_codes_np(codes)
            ok = valid_call_windows(codes)
            found, _, _, _ = t.lookup_np(hi, lo)
            found &= ok
            for p in np.nonzero(found)[0]:
                kmer_seqs.setdefault((int(hi[p]), int(lo[p])),
                                     set()).add(i)
        pairs: dict[tuple[int, int], int] = {}
        for seqs in kmer_seqs.values():
            ss = sorted(seqs)
            for a in range(len(ss)):
                for b in range(a + 1, len(ss)):
                    pairs[(ss[a], ss[b])] = pairs.get((ss[a], ss[b]), 0) + 1
        out = io.StringIO()
        for (a, b), count in sorted(pairs.items()):
            score = count / (lens[a] + lens[b])
            out.write(f"{batch.ids[a]}\t{batch.ids[b]}\t{count}\t"
                      f"{formats.cxx_num(score)}\n")
        return out.getvalue()

    def dump_mapping_text(self) -> str:
        """ref endpoint: GET /dump_mapping (kser_request.cc:273-412)."""
        return "".join(f"{k}\t{t.n_items}\n"
                       for k, t in sorted(self.mappings.items()))

    def checkpoint_text(self) -> str:
        """Persist the live table back to the data dir — the functional
        equivalent of the reference's BLCR /checkpoint
        (kser_request.cc:361-408): service state survives a restart."""
        self.table.save(Path(self.data_dir) / "kmer_data")
        return "checkpointed\n"

    def matrix_text(self, body: bytes) -> str:
        batch = fasta_io.SequenceBatch.from_records(
            fasta_io.iter_fasta(body))
        if self.multihost:
            # every rank runs the same collective compute, under the
            # dispatch lock for its whole length (its collectives must not
            # interleave with call dispatches)
            from .multihost import _dispatch_lock, broadcast_matrix

            with _dispatch_lock:
                broadcast_matrix(body)
                res = self.engines.distance.compute([batch], mesh=self.mesh)
        else:
            res = self.distance.compute([batch], mesh=self.mesh)
        out = io.StringIO()
        for s1, s2, count, score in res.rows(with_score=True):
            out.write(f"{s1}\t{s2}\t{count}\t{formats.cxx_num(score)}\n")
        return out.getvalue()


async def _handle(service: AnnotationService, stop_event: asyncio.Event,
                  reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
    try:
        request_line = await reader.readline()
        parts = request_line.decode("latin-1").split()
        if len(parts) < 2:
            return
        method, path = parts[0], parts[1]
        headers = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        body = b""
        if "content-length" in headers:
            body = await reader.readexactly(int(headers["content-length"]))

        loop = asyncio.get_event_loop()
        status, text = "200 OK", ""
        if method == "GET" and path == "/version":
            text = service.version_text()
        elif method == "GET" and path == "/quit":
            text = "OK\n"
            stop_event.set()
        elif method == "GET" and path == "/dump_sizes":
            text = service.dump_sizes_text()
        elif method == "GET" and path.startswith("/genus_lookup/"):
            text = service.genus_lookup_text(path.split("/", 2)[2])
        elif method == "POST" and path == "/add":
            async with service._lock:
                text = await loop.run_in_executor(
                    None, service.add_text, body)
        elif method == "GET" and path == "/dump_mapping":
            text = service.dump_mapping_text()
        elif method == "GET" and path == "/checkpoint":
            # off the loop thread, so every other route answers during
            # the save; the lock keeps /add from swapping the table
            async with service._lock:
                text = await loop.run_in_executor(
                    None, service.checkpoint_text)
        elif method == "POST" and path.startswith("/mapping/"):
            parts = path.split("/")
            if len(parts) == 4 and parts[3] in ("add", "lookup", "matrix"):
                key, op = parts[2], parts[3]
                fn = {"add": service.mapping_add_text,
                      "lookup": service.mapping_lookup_text,
                      "matrix": service.mapping_matrix_text}[op]
                if op == "add":  # writer: serializes with other adds
                    async with service._lock:
                        text = await loop.run_in_executor(None, fn, key, body)
                else:  # readers snapshot the mapping dict entry
                    text = await loop.run_in_executor(None, fn, key, body)
            else:
                status, text = "404 Not Found", "unknown mapping endpoint\n"
        elif method == "POST" and path == "/query":
            # coalesced: concurrent queries share caller batches
            text = await service.batcher.query(body)
        elif method == "POST" and path == "/lookup":
            text = await loop.run_in_executor(None, service.lookup_text, body)
        elif method == "POST" and path == "/fq_lookup":
            text = await loop.run_in_executor(
                None, service.fq_lookup_text, body)
        elif method == "POST" and path == "/matrix":
            text = await loop.run_in_executor(None, service.matrix_text, body)
        else:
            status, text = "404 Not Found", "unknown endpoint\n"

        payload = text.encode("latin-1")
        writer.write(
            (f"HTTP/1.1 {status}\r\nContent-Type: text/plain\r\n"
             f"Content-Length: {len(payload)}\r\n\r\n").encode("latin-1")
            + payload)
        await writer.drain()
    except Exception as e:  # noqa: BLE001 — answered as a 500
        try:
            msg = f"error: {e}\n".encode()
            writer.write(b"HTTP/1.1 500 Internal Server Error\r\n"
                         b"Content-Length: %d\r\n\r\n" % len(msg) + msg)
            await writer.drain()
        except Exception:  # noqa: BLE001 — the client went away
            pass
    finally:
        writer.close()


async def serve_async(data_dir, host="127.0.0.1", port=6100,
                      config: Config = Config(), device="cuda",
                      warm_len: int = 0, listen_port_file=None,
                      kmer_version=None, on_ready=None, mesh=None,
                      multihost: bool = False):
    """Serve until GET /quit.  on_ready(service, port), when given, is
    called once the server listens: a harness in the same process reaches
    the live service (its batcher and engines) through it.  multihost:
    rank 0 of a process-spanning mesh (service/multihost.py); a lost
    rank stops the server and raises once it has stopped."""
    service = AnnotationService(data_dir, config, device=device,
                                kmer_version=kmer_version, mesh=mesh,
                                multihost=multihost)
    if multihost:
        from ..parallel import distributed

        # every rank's service is built before the first frame
        distributed.barrier("service-built",
                            timeout=distributed.WORK_TIMEOUT)
    if warm_len:
        t0 = time.perf_counter()
        n = service.warm(warm_len)
        print(f"warmed {n} dispatch shapes (len {warm_len}) in "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    stop_event = asyncio.Event()
    beat = threading.Event()
    if multihost:
        from . import multihost as mh

        loop = asyncio.get_running_loop()
        mh.on_failure(lambda: loop.call_soon_threadsafe(stop_event.set))
        threading.Thread(target=mh.heartbeat, args=(beat,), daemon=True,
                         name="multihost-heartbeat").start()
    server = await asyncio.start_server(
        lambda r, w: _handle(service, stop_event, r, w), host, port)
    # port 0 means "choose a random port"; the bound port is announced
    # and (for harnesses) written to --listen-port-file, mirroring the
    # reference server (kmers-server.cc:44-46 listen-port-file /
    # "0 means to choose a random port")
    bound_port = server.sockets[0].getsockname()[1]
    if listen_port_file:
        tmp = f"{listen_port_file}.tmp{os.getpid()}"
        Path(tmp).write_text(f"{bound_port}\n")
        os.replace(tmp, listen_port_file)
    if port == 0:
        print(f"listening on port {bound_port}", file=sys.stderr,
              flush=True)
    if on_ready is not None:
        on_ready(service, bound_port)
    async with server:
        await stop_event.wait()
    # let in-flight coalesced batches finish before tearing down: /quit
    # must not abandon answered-but-unfinished requests
    while service.batcher._drain_tasks:
        await asyncio.gather(*list(service.batcher._drain_tasks),
                             return_exceptions=True)
    if multihost:
        beat.set()
        # the followers stop with the front end; in an executor, as the
        # broadcast takes the dispatch lock that a dispatch may hold
        await asyncio.get_running_loop().run_in_executor(
            None, mh.broadcast_quit)
        if mh.failure() is not None:
            raise RuntimeError(f"multihost service lost a rank: "
                               f"{mh.failure()}")


def serve(data_dir, host="127.0.0.1", port=6100, config: Config = Config(),
          device="cuda", warm_len: int = 0, listen_port_file=None,
          kmer_version=None, mesh=None, multihost: bool = False):
    asyncio.run(serve_async(data_dir, host, port, config, device=device,
                            warm_len=warm_len,
                            listen_port_file=listen_port_file,
                            kmer_version=kmer_version, mesh=mesh,
                            multihost=multihost))
